"""The real backend's step graphs (``jitcache.StepGraph``) on the CPU.

The CPU has no CUDA graphs, so these tests put a static-buffer replay
emulator in place of the capture (:func:`emulated_capture`, injected by
monkeypatching ``jitcache._capture`` and ``jitcache.graphs_available``):
it keeps fixed output tensors that every "replay" rewrites, as a graph
does, and like a capture it runs the wrappers (they tick) without
touching the cache.  So the graph path's bookkeeping is checked here
without a card: the aliasing of replayed outputs, the first eager call,
the launch counters and the capture counts.  Every served stream must
equal the eager backend's bit for bit, on the reduced llama (dense at
pipeline depth 1 and 4, paged, speculative at k = 2 with depth 1 and 4)
and the reduced mamba2.  The card runs the real capture
(``tests/test_torch_cuda.py``).

Also here: a mesh slice never captures and refuses ``cuda_graphs=True``
(a gloo world), the CPU refuses it, and the copied ``loopprof`` reads
the torch backend's dispatch / device-wait split
(tests/test_decision_plane.py:317).
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

import repro_torch.serving as TS
from repro_torch import kernels
from repro_torch.configs.registry import REGISTRY
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.core.power import A100
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.models import model as TM
from repro_torch.serving import jitcache, loopprof
from repro_torch.serving.cluster import build_predictor
from repro_torch.serving.realengine import (
    RealBackend,
    make_draft_config,
    make_real_backend_factory,
)
import _mesh_worlds as W

MAX_LEN = 128
SPEC_K = 2
LLAMA = REGISTRY["llama-3.1-8b"]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def emulated_capture(fn, params, kwargs, pool):
    """``jitcache._capture`` for the CPU.  The "capture" runs ``fn`` on a
    copy of every tree argument, so the wrappers tick as in a real
    capture while the cache stays as the eager first call left it; the
    outputs are fixed tensors.  ``replay()`` reruns ``fn`` on the static
    arguments, takes its wrapper ticks back out (a replay runs no
    wrapper), and copies the result into the fixed outputs."""
    scratch = {k: _clone_tree(v) for k, v in kwargs.items()
               if isinstance(v, dict)}
    out = fn(params, **{**kwargs, **scratch})
    back = {id(v): kwargs[k] for k, v in scratch.items()}
    fixed = tuple(torch.empty_like(o) if isinstance(o, torch.Tensor)
                  else back[id(o)] for o in out)

    def replay():
        before = kernels.launch_counts()
        res = fn(params, **kwargs)
        kernels.add_launches(kernels.launches_since(before), -1)
        for f, r in zip(fixed, res):
            if isinstance(f, torch.Tensor):
                f.copy_(r)

    return SimpleNamespace(replay=replay, pool=lambda: None), fixed


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(jitcache, "graphs_available", lambda device: True)
    monkeypatch.setattr(jitcache, "_capture", emulated_capture)


@pytest.fixture
def counting(monkeypatch):
    """The model's kernel wrappers count their calls on the CPU as they
    count launches on the card."""
    def counted(fn, bump):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            bump(a)
            return out
        return wrapper

    def ring(a):
        dops.launches += 1

    def paged(a):
        T = a[0].shape[1] if a[0].dim() == 4 else 1
        dops.paged_launches[T] = dops.paged_launches.get(T, 0) + 1

    def flash(a):
        fops.launches += 1

    def scan(a):
        sops.launches += 1

    for name, bump in (("decode_attention", ring),
                       ("paged_decode_attention", paged),
                       ("paged_verify_attention", paged),
                       ("flash_attention", flash), ("ssd_scan", scan)):
        monkeypatch.setattr(TM, name, counted(getattr(TM, name), bump))


@pytest.fixture(scope="module")
def side():
    rc = dataclasses.replace(LLAMA.reduced(), dtype="float32")
    params = TM.init_params(rc, torch.Generator().manual_seed(0),
                            device="cpu")
    dcfg = make_draft_config(rc)
    dparams = TM.init_params(dcfg, torch.Generator().manual_seed(1),
                             device="cpu")
    mc = REGISTRY["mamba2-2.7b"].reduced()
    mparams = TM.init_params(mc, torch.Generator().manual_seed(2),
                             device="cpu")
    pred = build_predictor(LLAMA, A100, A100.freq_levels_2,
                           kv_cap=400_000, spec_k=SPEC_K)
    return SimpleNamespace(rc=rc, params=params, dcfg=dcfg,
                           dparams=dparams, mc=mc, mparams=mparams,
                           pred=pred)


def _workload(vocab, seed=21):
    tiny = TS.DatasetDist("tiny", prefill=TS.LengthDist(24.0, 10.0, hi=60),
                          decode=TS.LengthDist(6.0, 3.0, hi=12))
    reqs = TS.poisson_workload(tiny, 2.5, 10.0, seed=seed)
    return TS.attach_tokens(reqs, vocab, seed=seed + 1)


# (model, backend keywords, cluster keywords, step entries a decode
# backend uses)
CASES = {
    "dense": ("llama", {}, {}, 1),
    "paged": ("llama", dict(paged=True, page_size=16),
              dict(paged=True, kv_page_size=16), 1),
    "spec": ("llama", dict(paged=True, page_size=16, spec_k=SPEC_K),
             dict(paged=True, kv_page_size=16, spec_decode=True,
                  spec_k=SPEC_K), 2),
    "mamba": ("mamba", {}, {}, 1),
}


def _serve(side, case, depth):
    model, bkw, ckw, _ = CASES[case]
    cfg, params = ((side.rc, side.params) if model == "llama"
                   else (side.mc, side.mparams))
    if bkw.get("spec_k"):
        bkw = dict(bkw, draft_cfg=side.dcfg, draft_params=side.dparams)
    factory = make_real_backend_factory(cfg, params, slots=8,
                                        max_len=MAX_LEN, device="cpu",
                                        pipeline_depth=depth, **bkw)
    reqs = _workload(cfg.vocab_size)
    cl = TS.PDCluster(TS.ClusterConfig(
        model=LLAMA, chip=A100, n_prefill=1, n_decode=2, policy="voltana",
        predictor=side.pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=4, noise_sigma=0.0,
        prefill_chunk_tokens=32, backend_factory=factory, **ckw))
    launches0 = kernels.launch_counts()
    compiles0 = jitcache.compile_count()
    graphs0 = (jitcache.capture_count(), jitcache.replay_count())
    m = cl.run(reqs)
    assert m.finished_frac() == 1.0
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1
    return SimpleNamespace(
        reqs=reqs, cluster=cl,
        streams=[list(r.output_tokens) for r in reqs],
        launches=kernels.launches_since(launches0),
        compiles=jitcache.compile_count() - compiles0,
        captures=jitcache.capture_count() - graphs0[0],
        replays=jitcache.replay_count() - graphs0[1])


@pytest.mark.parametrize("case,depth", [
    ("dense", 1), ("dense", 4), ("paged", 1), ("spec", 1), ("spec", 4),
    ("mamba", 1), ("mamba", 4)])
def test_emulated_graphs_serve_what_eager_serves(side, counting, monkeypatch,
                                                 case, depth):
    """The same workload, eager and through emulated graphs: bit-equal
    streams, the same first-seen shapes, the same launch counts, one
    capture per decode backend and entry it used, and every later step a
    replay."""
    jitcache.clear()
    eager = _serve(side, case, depth)
    assert eager.captures == eager.replays == 0
    assert eager.launches, "the counting wrappers never ran"
    jitcache.clear()
    monkeypatch.setattr(jitcache, "graphs_available", lambda device: True)
    monkeypatch.setattr(jitcache, "_capture", emulated_capture)
    graphs = _serve(side, case, depth)
    assert graphs.streams == eager.streams
    assert graphs.compiles == eager.compiles
    assert graphs.launches == eager.launches
    entries = CASES[case][3]
    steps = 0
    stepped = 0
    for e in graphs.cluster.decode:
        n = e.backend.pipeline_dispatches
        stepped += n > 0
        steps += n * (SPEC_K + 2 if case == "spec" else 1)
    assert graphs.captures == entries * stepped > 0
    assert graphs.replays == steps - graphs.captures > 0
    for e in graphs.cluster.prefill:
        assert e.backend._graphs._graphs == {}  # prefill stays eager


def test_second_run_on_the_same_backends_captures_nothing(side, emulated):
    """Graphs live with their backend: a second run over the same
    backends replays the graphs of the first."""
    jitcache.clear()
    backends = {}
    base = make_real_backend_factory(side.rc, side.params, slots=8,
                                     max_len=MAX_LEN, device="cpu")

    def factory(kind, idx, hw, seed, tp=None):
        key = (kind, idx)
        if key not in backends:
            backends[key] = base(kind, idx, hw, seed, tp=tp)
        return backends[key]

    def run():
        reqs = _workload(side.rc.vocab_size)
        TS.PDCluster(TS.ClusterConfig(
            model=LLAMA, chip=A100, n_prefill=1, n_decode=1,
            policy="voltana", predictor=side.pred,
            kv_capacity_tokens=400_000, online_adapt=False,
            decode_max_running=8, seed=4, backend_factory=factory,
        )).run(reqs)
        return [list(r.output_tokens) for r in reqs]

    first = run()
    n, replays = jitcache.capture_count(), jitcache.replay_count()
    assert n == 1
    assert run() == first
    assert jitcache.capture_count() == n
    assert jitcache.replay_count() > replays


def _one_slot_backend(side, **kw):
    hw = HardwareModel(LLAMA, A100)
    be = RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                     device="cpu", **kw)
    reqs = [TS.Request(i, 0.0, prompt_len=9, decode_len=4,
                       prompt_tokens=[(7 * i + j) % side.rc.vocab_size
                                      for j in range(9)])
            for i in range(2)]
    be.prefill_iter(reqs, 18, 1410.0)
    for r in reqs:
        be.insert(r)
    return be, reqs


def test_replayed_ids_do_not_alias_across_steps(side, emulated):
    """Each replay's ids are a copy: the ids of earlier steps, which the
    pipeline ring still holds, survive the next replay."""
    be, reqs = _one_slot_backend(side, pipeline_depth=4)
    held = []
    for _ in range(3):
        be.decode_iter(reqs, 2, 20, 1410.0)
        held.append(be._ring[-1][2])
    assert len({t.data_ptr() for t in held}) == 3
    want = [t.clone() for t in held]
    be.decode_iter(reqs, 2, 20, 1410.0)
    for t, w in zip(held, want):
        assert torch.equal(t, w)
    be.flush()


def test_replay_refuses_a_moved_cache_or_other_params(side, emulated):
    be, reqs = _one_slot_backend(side)
    be.decode_iter(reqs, 2, 20, 1410.0)  # eager, then the capture
    be.cache = _clone_tree(be.cache)
    with pytest.raises(RuntimeError, match="moved since its capture"):
        be.decode_iter(reqs, 2, 20, 1410.0)
    be2, reqs2 = _one_slot_backend(side)
    be2.decode_iter(reqs2, 2, 20, 1410.0)
    be2.params = dict(be2.params)
    with pytest.raises(RuntimeError, match="params it was captured with"):
        be2.decode_iter(reqs2, 2, 20, 1410.0)


def test_a_failed_capture_raises(side, monkeypatch):
    """No quiet fallback to eager: the step fails with the capture."""
    def broken(fn, params, kwargs, pool):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(jitcache, "graphs_available", lambda device: True)
    monkeypatch.setattr(jitcache, "_capture", broken)
    be, reqs = _one_slot_backend(side)
    with pytest.raises(RuntimeError, match="capture refused"):
        be.decode_iter(reqs, 2, 20, 1410.0)


def test_cuda_graphs_on_the_cpu_raise(side):
    with pytest.raises(ValueError, match="meshless backend on the card"):
        RealBackend(HardwareModel(LLAMA, A100), side.rc, side.params,
                    slots=2, max_len=64, device="cpu", cuda_graphs=True)
    be = RealBackend(HardwareModel(LLAMA, A100), side.rc, side.params,
                     slots=2, max_len=64, device="cpu")
    assert be._graphs is None  # the default off the card: eager


def test_mesh_slices_never_capture(side, tmp_path):
    """In a 2-rank gloo world with graphs made available on the CPU and a
    capture that fails the rank if it ever runs: a tp=2 cluster serves
    eagerly, and a sliced backend refuses ``cuda_graphs=True``."""
    pred = build_predictor(LLAMA, A100, A100.freq_levels_2, kv_cap=400_000)
    for res in W.start_world(W.graphs_rank, 2, tmp_path, side.rc,
                             side.params, pred).result():
        frac, captures, graphs, refused = res
        assert frac == 1.0
        assert captures == 0
        assert graphs and all(g is None for g in graphs)
        assert refused and "meshless backend on the card" in refused


def test_loopprof_reads_the_torch_backends_loop(side):
    """tests/test_decision_plane.py:317 on the torch backend: every
    backend iteration, including the engine spawned mid-run, goes
    through the profiler, and the breakdown's device wait is the
    backends' time blocked reading step results."""
    reqs = _workload(side.rc.vocab_size, seed=11)
    cl = TS.PDCluster(TS.ClusterConfig(
        model=LLAMA, chip=A100, n_prefill=1, n_decode=2, policy="voltana",
        predictor=side.pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=3,
        backend_factory=make_real_backend_factory(
            side.rc, side.params, slots=8, max_len=MAX_LEN, device="cpu",
            pipeline_depth=2)))
    cl.schedule_scale_out(2.0, "decode")
    prof = loopprof.install(cl)
    n0 = len(prof._engines)
    m = cl.run(reqs)
    assert m.finished_frac() == 1.0
    assert len(cl.decode) == 3
    assert len(prof._engines) == n0 + 1
    engines = list(cl.prefill) + list(cl.decode) + list(cl.hybrid)
    assert prof.iterations == sum(e.backend.n_iters for e in engines)
    bd = prof.breakdown(wall_s=1.0)
    waits = sum(e.backend.device_wait_s for e in engines)
    assert bd["device_wait_s"] == round(waits, 4)
    assert waits > 0.0
    assert bd["pipeline_depth_avg"] >= 1.0  # real steps were in flight
