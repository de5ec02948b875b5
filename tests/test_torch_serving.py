"""The port's serving stack against the JAX package's.

(a) The copied control plane is bit-exact: the same Sim-backend traces
    give identical per-request times, placements, preemptions and energy.
(b) A torch real cluster and a JAX real cluster on the reduced float32
    model give identical timing, placement, energy and stream lengths, and
    every torch token passes the near-argmax replay through the JAX model
    (tests/test_perf_invariants.py:206-239).
(c) Served tokens equal a direct port-model loop (tests/test_realengine.py:63).
(d) Dense preemption resume and failure restart over real compute.
(e) A second run over the same shapes adds 0 to ``compile_count()``.
"""
import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as JS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro.serving.realengine import make_real_backend_factory
import repro_torch.serving as TS
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.hwmodel import HardwareModel as THardwareModel
from repro_torch.core.power import A100 as TA100
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import jitcache
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import (
    RealBackend,
    _bucket,
    make_real_backend_factory as t_make_factory,
)

MAX_LEN = 128


@pytest.fixture(scope="module")
def jax_side():
    model = REGISTRY["llama-3.1-8b"]
    rc = dataclasses.replace(model.reduced(), dtype="float32")
    params = M.init_params(rc, jax.random.key(0))
    pred = build_predictor(model, A100, A100.freq_levels_2, kv_cap=400_000)
    return SimpleNamespace(
        pkg=JS, model=model, chip=A100, rc=rc, params=params, pred=pred,
        factory=lambda **kw: make_real_backend_factory(
            rc, params, slots=8, max_len=MAX_LEN, **kw),
    )


@pytest.fixture(scope="module")
def torch_side(jax_side):
    model = TREG["llama-3.1-8b"]
    rc = dataclasses.replace(model.reduced(), dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jax_side.params),
                             device="cpu")
    pred = t_build_predictor(model, TA100, TA100.freq_levels_2,
                             kv_cap=400_000)
    return SimpleNamespace(
        pkg=TS, model=model, chip=TA100, rc=rc, params=params, pred=pred,
        factory=lambda **kw: t_make_factory(
            rc, params, slots=8, max_len=MAX_LEN, device="cpu", **kw),
    )


def _workload(side, tiered=False, seed=21):
    p = side.pkg
    tiny = p.DatasetDist(
        "tiny",
        prefill=p.LengthDist(24.0, 10.0, hi=60),
        decode=p.LengthDist(6.0, 3.0, hi=12),
    )
    reqs = p.poisson_workload(tiny, 2.5, 10.0, seed=seed)
    if tiered:
        for r in reqs:
            r.tier = ("interactive", "standard", "batch")[r.rid % 3]
    return p.attach_tokens(reqs, side.rc.vocab_size, seed=seed + 1)


def _pressure_workload(side):
    """Batch-tier long decodes hold a tiny decode instance; an interactive
    burst lands meanwhile (forces preemption)."""
    p = side.pkg
    reqs = [p.Request(i, 0.01 * i, prompt_len=40, decode_len=80,
                      tier="batch") for i in range(3)]
    reqs += [p.Request(3 + j, 0.4 + 0.01 * j, prompt_len=60, decode_len=10,
                       tier="interactive") for j in range(3)]
    return p.attach_tokens(reqs, side.rc.vocab_size, seed=5)


SCENARIOS = {
    "plain-pd": dict(chunked_prefill=False, prefill_chunk_tokens=None),
    "chunked-pd": dict(prefill_chunk_tokens=32),
    "hybrid-tiered": dict(prefill_chunk_tokens=32, n_hybrid=1,
                          slo_tiers="tiers"),
    "paged-pd": dict(prefill_chunk_tokens=32, paged=True, kv_page_size=16,
                     n_hybrid=1),
    "pressure": dict(n_decode=1, kv_capacity_tokens=200,
                     prefill_chunk_tokens=32, slo_tiers="tiers",
                     admission_control=False),
}


def _cluster_cfg(side, scenario, **kw):
    base = dict(
        model=side.model, chip=side.chip, n_prefill=1, n_decode=2,
        policy="voltana", predictor=side.pred, kv_capacity_tokens=400_000,
        online_adapt=False, decode_max_running=8, seed=4, noise_sigma=0.0,
    )
    for k, v in SCENARIOS[scenario].items():
        base[k] = side.pkg.DEFAULT_TIERS if v == "tiers" else v
    base.update(kw)
    return side.pkg.ClusterConfig(**base)


def _reqs_for(side, scenario):
    if scenario == "pressure":
        return _pressure_workload(side)
    return _workload(side, tiered="tiered" in scenario)


def _assert_same_run(reqs_a, m_a, reqs_b, m_b, streams=True):
    """Everything the control plane computes, compared bit for bit (stream
    lengths too, unless one side is the token-less Sim backend)."""
    assert len(reqs_a) == len(reqs_b)
    for a, b in zip(reqs_a, reqs_b):
        assert a.rid == b.rid
        assert a.t_prefill_start == b.t_prefill_start
        assert a.t_first_token == b.t_first_token
        assert a.t_join_decode == b.t_join_decode
        assert a.t_finish == b.t_finish
        assert a.max_itl_s == b.max_itl_s
        assert a.prefill_instance == b.prefill_instance
        assert a.decode_instance == b.decode_instance
        assert a.preemptions == b.preemptions
        assert a.restarts == b.restarts
        if streams:
            assert len(a.output_tokens) == len(b.output_tokens)
    assert [e.name for e in m_a.instances] == [e.name for e in m_b.instances]
    for ea, eb in zip(m_a.instances, m_b.instances):
        assert ea.busy_j == eb.busy_j and ea.busy_s == eb.busy_s
    assert m_a.energy_j() == m_b.energy_j()
    # compile telemetry is per backend, not a control-plane output
    sa, sb = m_a.summary(), m_b.summary()
    sa.pop("recompiles", None)
    sb.pop("recompiles", None)
    assert sa == sb


# ---------------------------------------------------------------------------
# (a) the copied control plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_control_plane_copy_is_bit_exact(jax_side, torch_side, scenario):
    runs = []
    for side in (jax_side, torch_side):
        reqs = _reqs_for(side, scenario)
        cl = side.pkg.PDCluster(_cluster_cfg(side, scenario))
        if scenario == "chunked-pd":  # chaos: a failure and a scale-out
            cl.schedule_failure(3.0, "decode", 0)
            cl.schedule_scale_out(3.5, "decode")
        runs.append((reqs, cl.run(reqs)))
    (ra, ma), (rb, mb) = runs
    assert ma.finished_frac() == 1.0
    if scenario == "pressure":
        assert ma.preemptions_total() > 0, "scenario never preempted"
    _assert_same_run(ra, ma, rb, mb)


# ---------------------------------------------------------------------------
# (b) torch real cluster == JAX real cluster
# ---------------------------------------------------------------------------


def _replay_near_argmax(jax_side, reqs, margin=0.05):
    """Each emitted token's reference logit (JAX model, same weights)
    lies within ``margin`` of the reference max."""
    rc, params = jax_side.rc, jax_side.params
    prefill = jax.jit(partial(M.prefill, cfg=rc, max_len=MAX_LEN))
    decode = jax.jit(partial(M.decode_step, cfg=rc))
    for r in reqs:
        toks = jnp.asarray(r.prompt_tokens, jnp.int32)[None]
        pad = _bucket(toks.shape[1], hi=MAX_LEN)
        buf = jnp.zeros((1, pad), jnp.int32).at[:, : toks.shape[1]].set(toks)
        logits, cache = prefill(params, tokens=buf,
                                lengths=jnp.asarray([toks.shape[1]],
                                                    jnp.int32))
        pos = jnp.asarray([toks.shape[1]], jnp.int32)
        for i, tok in enumerate(r.output_tokens):
            row = np.asarray(logits[0], np.float64)
            assert row[tok] >= row.max() - margin, (
                f"rid {r.rid} token {i}: id {tok} has reference logit "
                f"{row[tok]:.4f} vs max {row.max():.4f}")
            logits, cache = decode(params, tokens=jnp.asarray([tok],
                                                              jnp.int32),
                                   cache=cache, lengths=pos)
            pos = pos + 1


@pytest.mark.parametrize("scenario", ["plain-pd", "chunked-pd",
                                      "hybrid-tiered"])
def test_torch_real_cluster_matches_jax_real_cluster(jax_side, torch_side,
                                                     scenario):
    runs = []
    for side in (jax_side, torch_side):
        reqs = _reqs_for(side, scenario)
        m = side.pkg.PDCluster(_cluster_cfg(
            side, scenario, backend_factory=side.factory())).run(reqs)
        assert m.finished_frac() == 1.0
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    _assert_same_run(ra, ma, rb, mb)
    if scenario == "plain-pd":
        _replay_near_argmax(jax_side, rb[:6])


# ---------------------------------------------------------------------------
# (c) served tokens == a direct port-model loop
# ---------------------------------------------------------------------------


def test_served_tokens_match_direct_model_loop(torch_side):
    side = torch_side
    reqs = _workload(side, seed=7)[:3]
    side.pkg.PDCluster(_cluster_cfg(
        side, "plain-pd", n_decode=1,
        backend_factory=side.factory())).run(reqs)
    for r in reqs:
        n = len(r.prompt_tokens)
        buf = torch.zeros((1, _bucket(n, hi=MAX_LEN)), dtype=torch.int32)
        buf[0, :n] = torch.tensor(r.prompt_tokens)
        logits, cache = TM.prefill(side.params, side.rc, buf,
                                   torch.tensor([n]), max_len=MAX_LEN)
        want = [int(logits[0].argmax())]
        pos = torch.tensor([n])
        for _ in range(r.decode_len):
            logits, cache = TM.decode_step(
                side.params, side.rc, torch.tensor([want[-1]]), cache, pos)
            want.append(int(logits[0].argmax()))
            pos = pos + 1
        assert r.output_tokens == want, f"req {r.rid} diverged"


@pytest.mark.parametrize("depth", [2, 4])
def test_pipeline_depth_emits_identical_streams(torch_side, depth):
    side = torch_side
    runs = []
    for d in (1, depth):
        reqs = _workload(side, tiered=True)
        m = side.pkg.PDCluster(_cluster_cfg(
            side, "hybrid-tiered",
            backend_factory=side.factory(pipeline_depth=d))).run(reqs)
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    _assert_same_run(ra, ma, rb, mb)
    assert [r.output_tokens for r in ra] == [r.output_tokens for r in rb]


# ---------------------------------------------------------------------------
# (d) preemption resume and failure restart over real compute
# ---------------------------------------------------------------------------


def test_dense_preemption_resume(torch_side):
    """The resume prefill rebuilds KV from prompt + delivered ids, the first
    token is not re-emitted, and Sim/Real parity holds through it
    (tests/test_backend_parity.py:287, dense)."""
    side = torch_side
    reqs_sim = _pressure_workload(side)
    reqs_real = _pressure_workload(side)
    m_sim = side.pkg.PDCluster(_cluster_cfg(side, "pressure")).run(reqs_sim)
    m_real = side.pkg.PDCluster(_cluster_cfg(
        side, "pressure", backend_factory=side.factory())).run(reqs_real)
    assert m_sim.preemptions_total() > 0, "scenario never preempted"
    _assert_same_run(reqs_sim, m_sim, reqs_real, m_real, streams=False)
    for r in reqs_real:
        assert len(r.output_tokens) == r.decode_len + 1


def test_failure_restart_token_hygiene(torch_side):
    """A failure restart regenerates from scratch: no stale pre-failure ids
    survive (tests/test_backend_parity.py:437)."""
    side = torch_side
    reqs = _pressure_workload(side)
    cl = side.pkg.PDCluster(_cluster_cfg(
        side, "pressure", n_decode=2, kv_capacity_tokens=400_000,
        backend_factory=side.factory()))
    cl.schedule_failure(0.3, "decode", 0)
    m = cl.run(reqs)
    assert m.finished_frac() == 1.0
    assert any(r.restarts > 0 for r in reqs), "failure hit nobody"
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1, r


# ---------------------------------------------------------------------------
# (e) compile telemetry
# ---------------------------------------------------------------------------


def test_second_run_adds_zero_compiles(torch_side):
    side = torch_side
    jitcache.clear()
    m1 = side.pkg.PDCluster(_cluster_cfg(
        side, "chunked-pd", backend_factory=side.factory())).run(
            _workload(side))
    assert m1.recompiles > 0, "warmup run recorded no shapes"
    assert m1.recompiles == jitcache.compile_count()
    n = jitcache.compile_count()
    m2 = side.pkg.PDCluster(_cluster_cfg(
        side, "chunked-pd", backend_factory=side.factory())).run(
            _workload(side))
    assert m2.recompiles == 0
    assert jitcache.compile_count() == n


def test_same_config_backends_share_entries(torch_side):
    side = torch_side
    hw = THardwareModel(side.model, side.chip)
    b1 = RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                     device="cpu")
    n = jitcache.entry_count()
    b2 = RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                     device="cpu")
    assert jitcache.entry_count() == n
    assert b1._decode_fn is b2._decode_fn
    assert b1._prefill_fn is b2._prefill_fn


# ---------------------------------------------------------------------------
# RealBackend edges (tests/test_realengine.py:98-157)
# ---------------------------------------------------------------------------


def test_bucket_helper():
    assert _bucket(10) == 16
    assert _bucket(17) == 32
    assert _bucket(70, hi=96) == 96
    assert _bucket(5, hi=96) == 16


def test_prefill_bucket_clamps_and_oversized_prompt_raises(torch_side):
    side = torch_side
    hw = THardwareModel(side.model, side.chip)
    be = RealBackend(hw, side.rc, side.params, slots=2, max_len=96,
                     device="cpu")
    r = side.pkg.Request(0, 0.0, prompt_len=70, decode_len=2,
                         prompt_tokens=list(np.arange(70) % 257))
    be.prefill_iter([r], 70, 1410.0)
    assert len(r.output_tokens) == 1
    big = side.pkg.Request(1, 0.0, prompt_len=97, decode_len=2,
                           prompt_tokens=list(np.arange(97) % 257))
    with pytest.raises(ValueError, match="exceeds the decode cache"):
        be.prefill_iter([big], 97, 1410.0)


def test_slot_reuse(torch_side):
    side = torch_side
    hw = THardwareModel(side.model, side.chip)
    be = RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                     device="cpu")
    reqs = [side.pkg.Request(i, 0.0, prompt_len=8, decode_len=2,
                             prompt_tokens=list(range(8))) for i in range(4)]
    be.prefill_iter(reqs, 32, 1410.0)
    be.insert(reqs[0])
    be.insert(reqs[1])
    assert not be.free
    with pytest.raises(RuntimeError, match="no free decode slots"):
        be.insert(reqs[2])
    be.release(reqs[0])
    be.insert(reqs[2])
    assert be.slot_of[reqs[2].rid] in (0, 1)
