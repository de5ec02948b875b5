"""The port's copies of the workload, scenario and analysis modules
against the JAX package's originals: ``serving/traces.py``,
``serving/loadgen.py``, ``serving/scenarios.py``, ``core/state_space.py``,
``distributed/commmodel.py`` with ``configs/shapes.py``, and
``launch/serve.py``.

(a) On the same seeds and calls as tests/test_traces.py,
    tests/test_loadgen.py, the ``state_space`` use of
    tests/test_slo_tiers.py:421 and the shape matrix of
    tests/test_sharding.py, each copy's output equals the original's bit
    for bit.
(b) Every scenario of ``SCENARIOS`` runs through the port's
    ``run_scenario`` at smoke scale (one predictor bank per side): the
    run equals the reference's in everything the control plane
    computes, and the port's ``check_pins`` passes against the
    reference's pins.
(c) Sim==Real through a scenario: the agentic multi-turn scenario (the
    head of its trace, its cluster) served by the torch ``RealBackend``
    on reduced llama gives the virtual clock of the port's Sim run.
"""
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

import repro.configs.shapes as JSH
import repro.core.state_space as JSS
import repro.distributed.commmodel as JCM
import repro.serving as JS
import repro.serving.loadgen as JLG
import repro.serving.scenarios as JSC
import repro.serving.traces as JT
import repro_torch.configs.shapes as TSH
import repro_torch.core.state_space as TSS
import repro_torch.distributed.commmodel as TCM
import repro_torch.serving as TS
import repro_torch.serving.loadgen as TLG
import repro_torch.serving.scenarios as TSC
import repro_torch.serving.traces as TT
from repro.configs.registry import ASSIGNED, REGISTRY
from repro.core.ecofreq import EcoFreq
from repro.core.power import A100
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.ecofreq import EcoFreq as TEcoFreq
from repro_torch.core.power import A100 as TA100
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import make_real_backend_factory
from _port_parity import assert_same_run

SIDES = {"jax": (JS, JT), "torch": (TS, TT)}


def _rows(trace):
    return [dataclasses.astuple(r) for r in trace.records]


def _reqs(reqs):
    return [(r.rid, r.arrival_s, r.prompt_len, r.decode_len, r.kind, r.tier,
             r.conv_id, r.turn, r.accept_rate, r.prompt_tokens)
            for r in reqs]


def _both(fn):
    """``fn(serving package, traces module)`` on each side."""
    return [fn(*SIDES[s]) for s in ("jax", "torch")]


# ---------------------------------------------------------------------------
# (a) traces
# ---------------------------------------------------------------------------


def _poisson(p, t, rps=5.0, duration=60.0, seed=0):
    return t.trace_from_requests(
        "t", p.poisson_workload(p.SHAREGPT, rps, duration, seed=seed))


@pytest.mark.parametrize("seed,factor,rps", [
    (0, 0.5, 3.0), (1, 2.0, 6.0), (2, 7.5, 1.5), (3, 0.25, 10.0),
])
def test_rescale_and_tile_equal_the_reference(seed, factor, rps):
    def run(p, t):
        src = _poisson(p, t, rps=rps, seed=seed)
        return [_rows(x) for x in (src, t.rescale(src, factor),
                                   t.rescale_to_rps(src, 6.0), t.tile(src, 4))]

    a, b = _both(run)
    assert a == b


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_resample_equals_the_reference(seed):
    def run(p, t):
        src = _poisson(p, t, rps=6.0, duration=120.0, seed=seed)
        out = t.resample(src, rps=8.0, duration_s=240.0, seed=seed + 1)
        return _rows(out), out.moments(), out.mean_rps

    a, b = _both(run)
    assert a == b


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_synthetic_trace_and_round_trip_equal_the_reference(seed, tmp_path):
    def run(p, t):
        src = t.synthetic_trace(
            [t.DiurnalSegment(duration_s=30.0, base_rps=2.0, peak_rps=6.0),
             t.AgenticSegment(duration_s=30.0, n_conversations=6,
                              turns_mean=3.0, think_mean_s=2.0),
             t.FlashCrowdSegment(duration_s=20.0, base_rps=2.0,
                                 spike_start_s=5.0),
             t.TieredSegment(duration_s=20.0, rps=3.0)],
            seed=seed, name="rt")
        path = tmp_path / f"{t.__name__}-{seed}.csv"
        src.save(str(path))
        return _rows(src), _rows(t.load_trace(str(path))), path.read_text()

    a, b = _both(run)
    assert a == b
    assert a[0] == a[1]  # lossless


def test_foreign_loaders_equal_the_reference():
    def run(p, t):
        return [_rows(x) for x in (
            t.load_azure_trace(t.AZURE_SAMPLE_CSV),
            t.load_burstgpt_trace(t.BURSTGPT_SAMPLE_CSV),
            t.load_trace(io.StringIO(t.AZURE_SAMPLE_CSV)),
            t.load_trace(io.StringIO(t.BURSTGPT_SAMPLE_CSV)))]

    a, b = _both(run)
    assert a == b and len(a[0]) == 64
    assert JT.AZURE_SAMPLE_CSV == TT.AZURE_SAMPLE_CSV
    assert JT.BURSTGPT_SAMPLE_CSV == TT.BURSTGPT_SAMPLE_CSV


@pytest.mark.parametrize("tokens", [False, True])
def test_to_requests_equals_the_reference(tokens):
    def run(p, t):
        src = t.synthetic_trace(
            [t.AgenticSegment(duration_s=40.0, n_conversations=5,
                              turns_mean=3.0, think_mean_s=2.0)],
            seed=4, name="req")
        back = t.trace_from_requests(
            "inv", p.poisson_workload(p.SHAREGPT, 4.0, 30.0, seed=9))
        return (_reqs(src.to_requests(tokens=tokens, seed=3)),
                _reqs(back.to_requests(tokens=tokens, seed=1)))

    a, b = _both(run)
    assert a == b


def test_malformed_traces_raise_alike():
    for t in (JT, TT):
        with pytest.raises(ValueError):
            t.Trace("bad", (t.TraceRecord(-1.0, 100, 10),))
        with pytest.raises(ValueError):
            t.Trace("bad", (t.TraceRecord(1.0, 100, 10),
                            t.TraceRecord(0.5, 100, 10)))


# ---------------------------------------------------------------------------
# (a) loadgen
# ---------------------------------------------------------------------------


def _points(pts):
    return [(p.rid, p.scheduled_s, p.fired_s, p.done_s) for p in pts]


@pytest.mark.parametrize("open_loop", [True, False])
def test_open_loop_driver_equals_the_reference(open_loop):
    arrivals = [i / 10.0 for i in range(40)]
    a, b = (_points(lg.OpenLoopDriver(open_loop=open_loop).run(
        arrivals, lg.FIFOServer(service_s=0.05, stall_until_s=3.0)))
        for lg in (JLG, TLG))
    assert a == b


def test_knees_equal_the_reference():
    rates = [float(r) for r in range(2, 42, 2)]
    for mu in (5.0, 10.0, 20.0):
        lat = [1.0 / (mu - r + 0.5) if r < mu else 2.0 + (r - mu)
               for r in rates]
        assert JLG.detect_knee(rates, lat) == TLG.detect_knee(rates, lat)
    att = [1.0, 0.99, 0.95, 0.6, 0.3]
    assert JLG.attainment_knee(rates[:5], att) == \
        TLG.attainment_knee(rates[:5], att) == 6.0
    assert JLG.detect_knee([2.0, 4.0, 6.0, 8.0], [0.1, 0.11, 0.1, 0.105]) \
        is TLG.detect_knee([2.0, 4.0, 6.0, 8.0], [0.1, 0.11, 0.1, 0.105]) \
        is None


# ---------------------------------------------------------------------------
# (b) scenarios, one predictor bank per side
# ---------------------------------------------------------------------------

_BANKS = {"jax": {}, "torch": {}}


@pytest.fixture(scope="module", params=sorted(JSC.SCENARIOS))
def scenario_pair(request):
    name = request.param
    out = {}
    for side, sc in (("jax", JSC), ("torch", TSC)):
        m, _, reqs = sc.run_scenario(name, smoke=True,
                                     predictor_bank=_BANKS[side])
        out[side] = (m, reqs)
    return name, out


def test_scenario_registries_are_the_same():
    assert sorted(JSC.SCENARIOS) == sorted(TSC.SCENARIOS)
    for name, s in JSC.SCENARIOS.items():
        t = TSC.SCENARIOS[name]
        assert (t.description, t.tokens, t.sweep_rates, t.pins) == \
            (s.description, s.tokens, s.sweep_rates, s.pins)
        assert repr(t.cluster_kw).replace("repro_torch.", "repro.") == \
            repr(s.cluster_kw)


def test_scenario_runs_equal_the_reference(scenario_pair):
    name, out = scenario_pair
    (jm, jreqs), (tm, treqs) = out["jax"], out["torch"]
    assert_same_run(jreqs, jm, treqs, tm)
    assert JSC.scenario_summary(jm) == TSC.scenario_summary(tm)


def test_scenario_pins_hold_in_the_port(scenario_pair):
    """The port's ``check_pins`` against the reference's golden pins."""
    name, out = scenario_pair
    summary = TSC.scenario_summary(out["torch"][0])
    pinned = dataclasses.replace(TSC.SCENARIOS[name],
                                 pins=JSC.SCENARIOS[name].pins)
    bad = TSC.check_pins(pinned, summary)
    assert not bad, "\n".join(bad)


# ---------------------------------------------------------------------------
# (a) state space, on the banks' predictors
# ---------------------------------------------------------------------------


def test_state_space_equals_the_reference():
    """tests/test_slo_tiers.py:421's fields, the speculative field and
    the Fig. 13 helpers, on predictors profiled for verify at k = 2."""
    grids = dict(n_req_grid=[1, 32, 96, 160],
                 n_kv_grid=[1_000, 200_000, 500_000])
    out = []
    for ss, build, ef_cls, model, chip in (
            (JSS, build_predictor, EcoFreq, REGISTRY["llama-3.1-8b"], A100),
            (TSS, t_build_predictor, TEcoFreq, TREG["llama-3.1-8b"], TA100)):
        pred = build(model, chip, chip.freq_levels_2, kv_cap=400_000,
                     spec_k=2)
        ef = ef_cls(chip.freq_levels_2, pred, 0.6, 0.06)
        fields = ss.tier_frequency_fields(
            ef, {"interactive": 0.06, "batch": 0.36}, **grids)
        out.append((
            {k: v.tolist() for k, v in fields.items()},
            ss.frequency_field(ef, **grids).tolist(),
            ss.spec_frequency_field(ef, accept_grid=[0.0, 0.5, 0.9],
                                    spec_k=2, **grids).tolist(),
            ss.frequency_cliffs(ef, n_kv=200_000, max_req=256),
            ss.acceptance_cliffs(ef, n_req=64, n_kv=200_000, spec_k=2),
            ss.tile_boundaries(chip, 512),
        ))
    assert out[0] == out[1]
    assert (np.asarray(out[1][0]["batch"])
            <= np.asarray(out[1][0]["interactive"])).all()


# ---------------------------------------------------------------------------
# (a) shapes and the analytic communication model
# ---------------------------------------------------------------------------


def _cell_numbers(cm, cfg, shape, mesh):
    cell = cm.CellModel(cfg, shape, mesh)
    out = {}
    for name in dir(cm.CellModel):
        if name.startswith("_"):
            continue
        attr = getattr(cm.CellModel, name)
        if isinstance(attr, property):
            out[name] = getattr(cell, name)
        elif callable(attr):
            try:
                out[name] = attr(cell)
            except TypeError:  # takes arguments beyond the cell
                continue
    return out


@pytest.mark.parametrize("arch", sorted(ASSIGNED) + ["llama-3.1-8b",
                                                     "qwen3-32b",
                                                     "ministral-3b"])
def test_shapes_and_commmodel_equal_the_reference(arch):
    """The shape matrix of tests/test_sharding.py (skip reasons, runnable
    cells) and every number ``CellModel`` derives, for every cell on
    three meshes."""
    cfg, tcfg = REGISTRY[arch], _port_config(arch)
    assert [s.__dict__ for s in JSH.SHAPES.values()] == \
        [s.__dict__ for s in TSH.SHAPES.values()]
    meshes = [(256, 16, 16, "tp"), (8, 4, 2, "tp"), (64, 8, 8, "fsdp_sp")]
    for sname in JSH.SHAPES:
        js, ts = JSH.SHAPES[sname], TSH.SHAPES[sname]
        assert JSH.cell_skip_reason(cfg, js) == \
            TSH.cell_skip_reason(tcfg, ts)
        for n, mdl, dp, mode in meshes:
            a = _cell_numbers(JCM, cfg, js, JCM.MeshView(n, mdl, dp, mode))
            b = _cell_numbers(TCM, tcfg, ts, TCM.MeshView(n, mdl, dp, mode))
            assert a == b and len(a) > 3, (sname, n, mode)


def _port_config(arch):
    """The port's config of ``arch``, or (for the architectures the port
    does not serve yet) the reference's fields in the port's class: the
    copies are data, whatever the model path serves."""
    if arch in TREG:
        return TREG[arch]
    from repro_torch.configs import base as TB

    cfg = REGISTRY[arch]
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["block_pattern"] = tuple(TB.LayerSpec(**dataclasses.asdict(s))
                                for s in cfg.block_pattern)
    for sub, cls in (("moe", TB.MoEConfig), ("mamba", TB.MambaConfig)):
        if kw[sub] is not None:
            kw[sub] = cls(**dataclasses.asdict(kw[sub]))
    return TB.ModelConfig(**kw)


def test_runnable_cells_equal_the_reference():
    assert JSH.runnable_cells(REGISTRY) == TSH.runnable_cells(
        {a: _port_config(a) for a in REGISTRY})


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-32b", "--dataset", "sharegpt", "--duration", "10"],
    ["--arch", "ministral-3b", "--dataset", "azure", "--duration", "10",
     "--n-prefill", "1", "--n-decode", "1"],
])
def test_serve_entry_point_equals_the_reference(argv, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve ...`` prints the reference's
    summary: the simulated cluster, no device."""
    import repro.launch.serve as JSV
    import repro_torch.launch.serve as TSV

    out = []
    for mod in (JSV, TSV):
        monkeypatch.setattr("sys.argv", [mod.__file__, *argv])
        mod.main()
        out.append(json.loads(capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[1]["finished_frac"] == 1.0


# ---------------------------------------------------------------------------
# (c) Sim==Real through a scenario
# ---------------------------------------------------------------------------

# the real backend's plain decode attention costs slots x context a step
# on the CPU: the whole smoke trace (82 requests, 13,534 decode tokens,
# 3,593 positions) takes minutes under a parallel test run
AGENTIC_REQUESTS = 16


@pytest.fixture
def one_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    on these context-long tensors oversubscribes the cores (the test ran
    25x slower in a 6-worker run than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_sim_equals_real_through_the_agentic_scenario(one_thread):
    """The agentic multi-turn scenario, cut short to the first
    ``AGENTIC_REQUESTS`` requests of its smoke trace (about 20 s: six
    conversations, up to 1,795 tokens of context), with token ids in the
    reduced vocabulary, its prefix-cached 2P2D cluster, decode batches
    of 8 and no timing noise (the real backend draws none, as
    tests/test_backend_parity.py:93 holds it), through the torch
    ``RealBackend`` on reduced llama in float32: the same virtual clock
    as the port's Sim run."""
    rc = dataclasses.replace(TREG["llama-3.1-8b"].reduced(), dtype="float32")
    jrc = dataclasses.replace(REGISTRY["llama-3.1-8b"].reduced(),
                              dtype="float32")
    params = params_from_jax(
        jax.tree.map(np.asarray, M.init_params(jrc, jax.random.key(0))),
        device="cpu")
    sc = TSC.SCENARIOS["agentic-multiturn"]
    bank = {}  # profiled for 8-request batches: not the scenarios' bank

    trace = sc.build(0, True)
    trace = TT.Trace(trace.name, trace.records[:AGENTIC_REQUESTS])

    def run(**kw):
        reqs = trace.to_requests(tokens=True, vocab_size=rc.vocab_size,
                                 seed=0)
        cfg = TSC.build_cluster_config(sc, predictor_bank=bank,
                                       decode_max_running=8, noise_sigma=0.0,
                                       **kw)
        return reqs, TS.PDCluster(cfg).run(reqs)

    max_len = max(r.prompt_len + r.decode_len + 1
                  for r in trace.to_requests())
    sim_reqs, sim = run()
    real_reqs, real = run(backend_factory=make_real_backend_factory(
        rc, params, slots=8, max_len=max_len, device="cpu"))
    assert_same_run(sim_reqs, sim, real_reqs, real, streams=False)
    assert real.finished_frac() == 1.0
    assert real.prefix_hit_rate > 0.3  # later turns reuse their prefixes
    for r in real_reqs:
        assert len(r.output_tokens) == r.decode_len + 1
        assert all(0 <= t < rc.vocab_size for t in r.output_tokens)
