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
(f) The paged pool and speculative draft–verify: torch and JAX paged
    (and paged + speculative) real clusters are bit-equal in everything
    the control plane computes; Sim==Real through speculation, slot
    capacity, preemption, multi-turn prefix reuse and prefill failure
    (tests/test_backend_parity.py:161-437), pipeline depth through
    speculation (tests/test_perf_invariants.py:243).
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.serving as JS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro.serving.realengine import (
    make_draft_config,
    make_real_backend_factory,
)
import repro_torch.serving as TS
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.hwmodel import HardwareModel as THardwareModel
from repro_torch.core.power import A100 as TA100
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import jitcache
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from _port_parity import (
    assert_same_run,
    recording,
    replay_by_kind,
    replay_near_argmax,
    token_kinds,
)
from repro_torch.serving.realengine import (
    RealBackend,
    _bucket,
    make_draft_config as t_make_draft_config,
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
    assert_same_run(ra, ma, rb, mb)


# ---------------------------------------------------------------------------
# (b) torch real cluster == JAX real cluster
# ---------------------------------------------------------------------------


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
    assert_same_run(ra, ma, rb, mb)
    if scenario == "plain-pd":
        replay_near_argmax(jax_side.rc, jax_side.params, rb[:6], MAX_LEN)


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
    assert_same_run(ra, ma, rb, mb)
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
    assert_same_run(reqs_sim, m_sim, reqs_real, m_real, streams=False)
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



# ---------------------------------------------------------------------------
# (f) paged pool and speculative draft–verify
# ---------------------------------------------------------------------------

SPEC_K = 2


@pytest.fixture(scope="module")
def spec(jax_side, torch_side):
    """Each side's drafter (the same weights, carried across) and a
    predictor profiled for verify iterations."""
    jdc = make_draft_config(jax_side.rc)
    jdp = M.init_params(jdc, jax.random.key(1))
    tdc = t_make_draft_config(torch_side.rc)
    tdp = params_from_jax(jax.tree.map(np.asarray, jdp), device="cpu")
    jpred = build_predictor(jax_side.model, A100, A100.freq_levels_2,
                            kv_cap=400_000, spec_k=SPEC_K)
    tpred = t_build_predictor(torch_side.model, TA100, TA100.freq_levels_2,
                              kv_cap=400_000, spec_k=SPEC_K)
    return {
        "jax": SimpleNamespace(draft_cfg=jdc, draft_params=jdp, pred=jpred),
        "torch": SimpleNamespace(draft_cfg=tdc, draft_params=tdp,
                                 pred=tpred),
    }


def _spec_kw(sp, **kw):
    """Backend keywords of a paged + speculative factory."""
    return dict(paged=True, page_size=16, spec_k=SPEC_K,
                draft_cfg=sp.draft_cfg, draft_params=sp.draft_params, **kw)


def _spec_cluster_cfg(side, sp, **kw):
    base = dict(prefill_chunk_tokens=32, paged=True, kv_page_size=16,
                spec_decode=True, spec_k=SPEC_K, predictor=sp.pred)
    base.update(kw)
    return _cluster_cfg(side, "chunked-pd", **base)


def test_torch_paged_real_cluster_matches_jax(jax_side, torch_side):
    """The paged memory model: same workload through a JAX and a torch
    paged real cluster (a hybrid instance exercises the local join)."""
    runs = []
    for side in (jax_side, torch_side):
        reqs = _workload(side)
        m = side.pkg.PDCluster(_cluster_cfg(
            side, "paged-pd",
            backend_factory=side.factory(paged=True, page_size=16))).run(reqs)
        assert m.finished_frac() == 1.0
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    assert_same_run(ra, ma, rb, mb)
    replay_near_argmax(jax_side.rc, jax_side.params, rb[:6], MAX_LEN)


def test_torch_spec_real_cluster_matches_jax(jax_side, torch_side, spec):
    """Paged + speculative: bit-equal control plane (acceptance
    realizations included), complete streams, drained pools, and every
    token near the argmax of the model that chose it."""
    runs = []
    for side, sp in ((jax_side, spec["jax"]), (torch_side, spec["torch"])):
        reqs = _workload(side)
        factory, log = recording(side.factory(**_spec_kw(sp)))
        cl = side.pkg.PDCluster(_spec_cluster_cfg(side, sp,
                                                  backend_factory=factory))
        m = cl.run(reqs)
        assert m.finished_frac() == 1.0
        assert m.spec_iterations() > 0
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
        for e in cl.decode:
            e.backend.pool.assert_empty()
        runs.append((reqs, m, log))
    (ra, ma, la), (rb, mb, lb) = runs
    assert_same_run(ra, ma, rb, mb)
    for a, b in zip(ra, rb):
        assert (a.spec_iters, a.spec_accepted) == (b.spec_iters,
                                                   b.spec_accepted)
    assert la == lb and any(a > 0 for _, a in lb)
    replay_by_kind(
        {"target": (jax_side.rc, jax_side.params),
         "draft": (spec["jax"].draft_cfg, spec["jax"].draft_params)},
        rb[:6], token_kinds(rb, lb), MAX_LEN)


def test_sim_and_real_agree_through_speculation(torch_side, spec):
    """tests/test_backend_parity.py:161 in the port."""
    side, sp = torch_side, spec["torch"]
    reqs_sim, reqs_real = _workload(side), _workload(side)
    m_sim = side.pkg.PDCluster(_spec_cluster_cfg(side, sp)).run(reqs_sim)
    cl = side.pkg.PDCluster(_spec_cluster_cfg(
        side, sp, backend_factory=side.factory(**_spec_kw(sp))))
    m_real = cl.run(reqs_real)
    assert m_sim.spec_iterations() > 0
    assert_same_run(reqs_sim, m_sim, reqs_real, m_real, streams=False)
    for rs, rr in zip(reqs_sim, reqs_real):
        assert (rs.spec_iters, rs.spec_accepted) == (rr.spec_iters,
                                                     rr.spec_accepted)
        assert len(rr.output_tokens) == rr.decode_len + 1
    assert m_sim.acceptance_rate() == m_real.acceptance_rate()
    for e in cl.decode:
        e.backend.pool.assert_empty()
    assert sum(e.backend.spec_real_drafted for e in cl.decode) > 0


def test_real_spec_at_slot_capacity(torch_side, spec):
    """tests/test_backend_parity.py:211: a context that tops out at the
    slot capacity completes; the verify window clamps at max_len and the
    overflow rows scatter to the scratch page."""
    side, sp = torch_side, spec["torch"]
    max_len = 64
    reqs = [side.pkg.Request(0, 0.0, prompt_len=40, decode_len=24),
            side.pkg.Request(1, 0.05, prompt_len=33, decode_len=12)]
    side.pkg.attach_tokens(reqs, side.rc.vocab_size, seed=6)
    cl = side.pkg.PDCluster(_spec_cluster_cfg(
        side, sp, n_decode=1, decode_max_running=4,
        backend_factory=t_make_factory(
            side.rc, side.params, slots=4, max_len=max_len, device="cpu",
            **_spec_kw(sp))))
    m = cl.run(reqs)
    assert m.finished_frac() == 1.0
    for r in reqs:
        assert r.kv_len == r.prompt_len + r.decode_len <= max_len
        assert len(r.output_tokens) == r.decode_len + 1
    cl.decode[0].backend.pool.assert_empty()


def test_real_spec_requires_paged_and_a_drafter(torch_side, spec):
    """tests/test_backend_parity.py:246, with ValueError for the JAX
    backend's asserts; a slice narrower than the world (disjoint
    slices) still raises."""
    side, sp = torch_side, spec["torch"]
    hw = THardwareModel(side.model, side.chip)
    with pytest.raises(ValueError, match="paged"):
        RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                    paged=False, spec_k=2, draft_cfg=sp.draft_cfg,
                    draft_params=sp.draft_params, device="cpu")
    with pytest.raises(ValueError, match="draft model"):
        RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                    paged=True, spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of page_size"):
        RealBackend(hw, side.rc, side.params, slots=2, max_len=60,
                    paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="disjoint ranks"):
        t_make_factory(side.rc, side.params, tp=2, devices=[0, 1, 2, 3],
                       device="cpu")


def test_paged_preemption_resume(torch_side):
    """tests/test_backend_parity.py:287, paged: Sim/Real parity through
    preempt/resume, complete streams, the victim's pages returned."""
    side = torch_side
    reqs_sim, reqs_real = _pressure_workload(side), _pressure_workload(side)
    kw = dict(paged=True, kv_page_size=16)
    m_sim = side.pkg.PDCluster(_cluster_cfg(side, "pressure", **kw)).run(
        reqs_sim)
    cl = side.pkg.PDCluster(_cluster_cfg(
        side, "pressure", **kw,
        backend_factory=side.factory(paged=True, page_size=16)))
    m_real = cl.run(reqs_real)
    assert m_sim.preemptions_total() > 0, "scenario never preempted"
    assert_same_run(reqs_sim, m_sim, reqs_real, m_real, streams=False)
    for r in reqs_real:
        assert len(r.output_tokens) == r.decode_len + 1
    for e in cl.decode:
        e.backend.pool.assert_empty()


def _multiturn_reqs(side, n_convs=2, n_turns=3, system_len=48):
    """Conversations sharing a system prompt, each turn a strict
    extension of the last (tests/test_backend_parity.py:317)."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, side.rc.vocab_size, system_len).tolist()
    hist = {c: list(system) for c in range(n_convs)}
    reqs, rid = [], 0
    for turn in range(n_turns):
        for c in range(n_convs):
            prompt = hist[c] + rng.integers(0, side.rc.vocab_size,
                                            8).tolist()
            r = side.pkg.Request(rid, 2.0 * turn + 0.3 * c,
                                 prompt_len=len(prompt), decode_len=4,
                                 conv_id=c, turn=turn)
            r.prompt_tokens = list(prompt)
            reqs.append(r)
            rid += 1
            hist[c] = prompt + [0] * 4  # prompt + synthetic outputs
    return reqs


def _radix_pages(cache):
    pages, stack = [], [cache.root]
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        pages.extend(n.pages)
    return pages


def test_paged_multiturn_prefix_reuse(jax_side, torch_side):
    """tests/test_backend_parity.py:340: prefix pages are reused (refcount
    > 1), reused tokens never re-enter the forward (the suffix prefill
    runs flash with a query offset), pools balance; and the torch run
    equals the JAX one."""
    runs = []
    for side in (jax_side, torch_side):
        reqs = _multiturn_reqs(side)
        cl = side.pkg.PDCluster(_cluster_cfg(
            side, "plain-pd", n_decode=1, prefill_chunk_tokens=64,
            chunked_prefill=True, prefix_cache=True,
            prefix_cache_capacity=2_048, paged=True, kv_page_size=16,
            backend_factory=side.factory(paged=True, page_size=16,
                                         pool_pages=256)))
        m = cl.run(reqs)
        assert m.finished_frac() == 1.0
        assert m.prefix_hit_rate and m.prefix_hit_rate > 0.3
        pb = cl.prefill[0].backend
        assert pb.reused_tokens > 0
        assert pb.computed_tokens == sum(r.prompt_len for r in reqs) \
            - pb.reused_tokens
        assert pb.pool.stats.max_refcount > 1
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
        radix = _radix_pages(cl.prefill[0].cache)
        assert pb.pool.in_use == len(set(radix))
        assert all(pb.pool.refcount(p) == 1 for p in radix)
        cl.decode[0].backend.pool.assert_empty()
        runs.append((reqs, m, (pb.reused_tokens, pb.computed_tokens)))
    (ra, ma, ca), (rb, mb, cb) = runs
    assert_same_run(ra, ma, rb, mb)
    assert ca == cb
    replay_near_argmax(jax_side.rc, jax_side.params, rb, MAX_LEN)


def test_paged_prefill_failure_releases_stashed_pages(torch_side):
    """tests/test_backend_parity.py:393."""
    side = torch_side
    reqs = _pressure_workload(side)
    cl = side.pkg.PDCluster(_cluster_cfg(
        side, "pressure", n_prefill=2, n_decode=2,
        kv_capacity_tokens=400_000, prefix_cache=True,
        prefix_cache_capacity=1_024, paged=True, kv_page_size=16,
        backend_factory=side.factory(paged=True, page_size=16)))
    cl.schedule_failure(0.05, "prefill", 0)
    m = cl.run(reqs)
    assert m.finished_frac() == 1.0
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1
    dead = cl.prefill[0].backend
    assert not dead._pstash
    assert dead.pool.in_use == len(set(_radix_pages(cl.prefill[0].cache)))
    for e in cl.decode:
        e.backend.pool.assert_empty()


def test_pipeline_depth_parity_through_speculation(torch_side, spec):
    """tests/test_perf_invariants.py:243: chunked prefill, tiers, paged KV
    and speculation at depth 1, 2 and 4 emit identical streams with 0
    recompiles once warm, and depth 4 keeps more than one iteration in
    flight."""
    side, sp = torch_side, spec["torch"]
    jitcache.clear()
    runs = {}
    for depth in (1, 1, 2, 4):  # the first depth-1 run warms the shapes
        reqs = _workload(side, tiered=True)
        cl = side.pkg.PDCluster(_spec_cluster_cfg(
            side, sp, slo_tiers=side.pkg.DEFAULT_TIERS,
            backend_factory=side.factory(
                **_spec_kw(sp, pipeline_depth=depth))))
        m = cl.run(reqs)
        assert m.finished_frac() == 1.0
        runs[depth] = (reqs, m, cl)
    ref_reqs, ref_m, _ = runs[1]
    assert ref_m.recompiles == 0 and ref_m.spec_iterations() > 0
    for depth in (2, 4):
        reqs, m, cl = runs[depth]
        assert m.recompiles == 0
        assert m.energy_j() == ref_m.energy_j()
        for a, b in zip(ref_reqs, reqs):
            assert a.output_tokens == b.output_tokens
            assert (a.t_first_token, a.t_finish, a.decode_instance) == (
                b.t_first_token, b.t_finish, b.decode_instance)
        for e in cl.decode:
            assert e.backend.pipeline_depth == depth
            assert not e.backend._ring
    cl4 = runs[4][2]
    disp = sum(e.backend.pipeline_dispatches for e in cl4.decode)
    occ = sum(e.backend.pipeline_depth_sum for e in cl4.decode)
    assert disp > 0 and occ / disp > 1.0


def test_second_paged_spec_run_adds_zero_compiles(torch_side, spec):
    side, sp = torch_side, spec["torch"]
    jitcache.clear()

    def run():
        return side.pkg.PDCluster(_spec_cluster_cfg(
            side, sp,
            backend_factory=side.factory(**_spec_kw(sp)))).run(
                _workload(side))

    m1 = run()
    assert m1.spec_iterations() > 0 and m1.recompiles > 0
    n = jitcache.compile_count()
    m2 = run()
    assert m2.recompiles == 0 and jitcache.compile_count() == n
