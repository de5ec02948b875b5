"""Prefill and decode instances on disjoint ranks, the P→D handoff
crossing ranks, against the JAX package and the port's meshless path.

The JAX package serves disjoint slices: ``MeshSlicer`` hands out slices
while ranks last and ``RealBackend.insert`` re-lays the handed-off cache
onto its own slice with ``jax.device_put``
(``repro/serving/realengine.py:503-511``, ``:525-528``).  Here the port
does the same in spawned gloo worlds on the CPU (``_mesh_worlds.py``,
no JAX in the ranks), on the reduced models in float32:

* a 2-rank world of tp=1 slices with ``cluster_cfg``'s fleet (prefill on
  rank 0, decode 0 on rank 1, decode 1 back on rank 0): the dense ring
  and paged speculation against the JAX meshless cluster
  (``assert_same_run``), bit-equal to the port's meshless cluster, the
  same streams on both ranks, at least one handoff across ranks and one
  local, pools drained, and remote instances that hold nothing;
* the same world on reduced Mamba2 (a conv tail and SSM state cross
  ranks) and on llama's int8 ring (codes and float32 scales);
* a 3-rank world of unequal widths (prefill at tp=1 on rank 0, decode at
  tp=2 on ranks 1-2) against the JAX meshless cluster at the same fleet;
* the head-range plan, and the factory's slices (int8 too) built
  before any process group.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.serving as JS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro.serving.realengine import make_draft_config, make_real_backend_factory
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.power import A100 as TA100
from repro_torch.distributed.handoff import head_plan
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import (
    make_draft_config as t_make_draft,
    make_real_backend_factory as t_factory,
)
import _mesh_worlds as W
from _mamba_weights import live_state
from _port_parity import (
    assert_same_run,
    recording,
    replay_by_kind,
    replay_near_argmax,
    token_kinds,
)

LLAMA = REGISTRY["llama-3.1-8b"]
UNEQUAL = (1, 2)  # (prefill, decode) slice widths of the 3-rank world


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reduced(reg, arch, **kw):
    return dataclasses.replace(reg[arch].reduced(), dtype="float32", **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("disjoint")
    rc = _reduced(REGISTRY, "llama-3.1-8b")
    params = M.init_params(rc, jax.random.key(0))
    dcfg = make_draft_config(rc)
    dparams = M.init_params(dcfg, jax.random.key(1))
    mrc = _reduced(REGISTRY, "mamba2-2.7b")
    mparams = live_state(_np(M.init_params(mrc, jax.random.key(0))), mrc)

    trc = _reduced(TREG, "llama-3.1-8b")
    tmrc = _reduced(TREG, "mamba2-2.7b")
    tllama = TREG["llama-3.1-8b"]

    def pred(model, **kw):
        return t_build_predictor(model, TA100, TA100.freq_levels_2,
                                 kv_cap=400_000, **kw)

    ring = pred(tllama)
    preds = {"ring": ring, "int8": ring, "spec": pred(tllama, spec_k=W.SPEC_K),
             "mamba": pred(TREG["mamba2-2.7b"])}
    cases = [
        ("ring", trc, _np(params), None, None),
        ("spec", trc, _np(params), t_make_draft(trc), _np(dparams)),
        ("mamba", tmrc, mparams, None, None),
        ("int8", dataclasses.replace(trc, kv_dtype="int8"), _np(params),
         None, None),
    ]
    bank = {(TA100.name, tp): pred(tllama, tp=tp) for tp in set(UNEQUAL)}
    worlds = {
        "tp1": W.start_world(W.disjoint_rank, 2, tmp, cases, preds),
        "unequal": W.start_world(W.unequal_rank, 3, tmp, trc, _np(params),
                                 UNEQUAL, bank),
    }
    yield dict(rc=rc, params=params, dcfg=dcfg, dparams=dparams,
               worlds=worlds)
    for w in worlds.values():  # a test that failed early leaves none alive
        for p in w.procs:
            if p.is_alive():
                p.kill()


def _jax_run(ref, name):
    """The JAX meshless cluster of case ``name`` ("ring" or "spec"):
    (reqs, metrics, acceptance log)."""
    kw, ckw = {}, {}
    if name == "spec":
        kw = dict(paged=True, page_size=16, spec_k=W.SPEC_K,
                  draft_cfg=ref["dcfg"], draft_params=ref["dparams"])
        ckw = dict(paged=True, kv_page_size=16, spec_decode=True,
                   spec_k=W.SPEC_K)
    pred = build_predictor(LLAMA, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=W.SPEC_K if name == "spec" else 0)
    factory, log = recording(make_real_backend_factory(
        ref["rc"], ref["params"], slots=8, max_len=W.MAX_LEN, **kw))
    reqs = W.workload(JS, ref["rc"].vocab_size)
    m = JS.PDCluster(W.cluster_cfg(JS, LLAMA, A100, pred,
                                   backend_factory=factory, **ckw)).run(reqs)
    return reqs, m, log


def _same_as_meshless(ranks, name):
    """Both ranks emitted the same streams, bit-equal in streams and
    ``t_finish`` to the port's meshless cluster run in rank 0, and the
    run had a crossing and a local handoff, drained pools and remote
    instances that held nothing."""
    res = [r[name] for r in ranks]
    (rb, mb, lb), (rc_, _, lc) = res[0]["disjoint"], res[1]["disjoint"]
    rm, mm, lm = res[0]["meshless"]
    assert mb.finished_frac() == mm.finished_frac() == 1.0
    assert_same_run(rm, mm, rb, mb)
    assert lb == lc == lm
    for a, b, c in zip(rm, rb, rc_):
        assert a.output_tokens == b.output_tokens == c.output_tokens, \
            f"{name}: request {a.rid} diverged"
        assert a.t_finish == b.t_finish == c.t_finish
        assert len(b.output_tokens) == b.decode_len + 1
    for rank, r in enumerate(res):
        facts = r["facts"]
        assert [k for k, _ in facts["ranks"]] == ["prefill", "decode",
                                                  "decode"]
        assert [rk for _, rk in facts["ranks"]] == [(0,), (1,), (0,)]
        assert facts["local"] == [rank == 0, rank == 1, rank == 0]
        assert facts["crossed"] >= 1 and facts["local_handoffs"] >= 1, facts
        assert all(n == 0 for n in facts["pages_in_use"]), facts
    return rb, lb


@pytest.mark.parametrize("name", ["ring", "spec"])
def test_disjoint_cluster_matches_jax_meshless_cluster(ref, name):
    """tp=1 slices on disjoint ranks against the JAX meshless cluster:
    bit-equal control plane and stream lengths (and acceptances), every
    token within 0.05 of the JAX model's max logit."""
    ranks = ref["worlds"]["tp1"].result()
    rb, lb = _same_as_meshless(ranks, name)
    ra, ma, la = _jax_run(ref, name)
    assert ma.finished_frac() == 1.0
    assert_same_run(ra, ma, rb, ranks[0][name]["disjoint"][1])
    if name == "ring":
        replay_near_argmax(ref["rc"], ref["params"], rb, W.MAX_LEN)
    else:
        assert la == lb and any(a > 0 for _, a in lb)
        replay_by_kind({"target": (ref["rc"], ref["params"]),
                        "draft": (ref["dcfg"], ref["dparams"])},
                       rb, token_kinds(rb, lb), W.MAX_LEN)


@pytest.mark.parametrize("name", ["mamba", "int8"])
def test_handoff_trees_cross_ranks(ref, name):
    """A Mamba2 conv tail and SSM state, and an int8 ring's codes with
    their float32 scales, cross ranks at tp=1: the streams equal the
    port's meshless run."""
    _same_as_meshless(ref["worlds"]["tp1"].result(), name)


@pytest.mark.parametrize("name", ["ring", "spec"])
def test_remote_instances_hold_nothing(ref, name):
    """An instance on a rank outside its slice holds no weights, cache or
    drafter (rank 0 holds decode 0 remotely, rank 1 the prefill and
    decode 1), and only a crossing handoff moves bytes: rank 0 sends,
    rank 1 receives."""
    for rank, res in enumerate(ref["worlds"]["tp1"].result()):
        facts = res[name]["facts"]
        assert len(facts["remote_empty"]) == (1 if rank == 0 else 2)
        assert all(facts["remote_empty"])
        moved = [(s, r) for _, s, r, _ in facts["handoff_log"]
                 if s or r]
        assert moved, f"rank {rank} moved no bytes"
        # rank 0 only sends (it holds the prefill), rank 1 only receives
        assert all((r == 0) == (rank == 0) and (s == 0) == (rank == 1)
                   for s, r in moved)


def test_unequal_widths_match_jax_meshless_cluster(ref):
    """Prefill at tp=1 on rank 0, decode at tp=2 on ranks 1-2: each
    decode rank takes its half of the kv heads from rank 0.  Held against
    the JAX meshless cluster at the same fleet, as the tp=2 tests hold
    theirs."""
    ranks = ref["worlds"]["unequal"].result()
    pred = {tp: build_predictor(LLAMA, A100, A100.freq_levels_2,
                                kv_cap=400_000, tp=tp) for tp in UNEQUAL}
    reqs = W.workload(JS, ref["rc"].vocab_size)
    ma = JS.PDCluster(W.cluster_cfg(
        JS, LLAMA, A100, None,
        prefill_fleet=[JS.InstanceSpec(A100, UNEQUAL[0])],
        decode_fleet=[JS.InstanceSpec(A100, UNEQUAL[1])],
        predictor_bank={(A100.name, tp): p for tp, p in pred.items()},
        backend_factory=make_real_backend_factory(
            ref["rc"], ref["params"], slots=8, max_len=W.MAX_LEN))).run(reqs)
    rb, mb, facts = ranks[0]
    assert ma.finished_frac() == mb.finished_frac() == 1.0
    assert_same_run(reqs, ma, rb, mb)
    for rank, (r_, _, f) in enumerate(ranks):
        assert f["ranks"] == [("prefill", (0,)), ("decode", (1, 2))]
        assert f["crossed"] >= len(rb) and f["local_handoffs"] == 0
        for a, b in zip(rb, r_):
            assert a.output_tokens == b.output_tokens, \
                f"rank {rank} differs, {a.rid}"
    replay_near_argmax(ref["rc"], ref["params"], rb, W.MAX_LEN)


# ---------------------------------------------------------------------------
# The plan and the refusals, no world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp_src,tp_dst", [(1, 2), (2, 1), (2, 4), (4, 2),
                                           (1, 8)])
def test_head_plan_covers_every_head_once(tp_src, tp_dst):
    """Hkv 8 over disjoint slices: every destination rank's heads come
    once each, in order, from the source rank that holds them."""
    hkv = 8
    src = list(range(tp_src))
    dst = list(range(tp_src, tp_src + tp_dst))
    plan = head_plan(hkv, src, dst)
    assert list(plan) == dst
    seen = []
    for j, d in enumerate(dst):
        want = list(range(j * hkv // tp_dst, (j + 1) * hkv // tp_dst))
        got = []
        for p in plan[d]:
            assert p.dst == d
            holder = src[p.lo * tp_src // hkv]
            assert p.src == holder and (p.hi - 1) * tp_src // hkv == \
                p.lo * tp_src // hkv, p
            assert p.src_off == p.lo - (p.lo * tp_src // hkv) * (
                hkv // tp_src)
            assert p.dst_off == p.lo - want[0]
            got += range(p.lo, p.hi)
        assert got == want
        seen += got
    assert seen == list(range(hkv))


def test_head_plan_prefers_a_local_holder():
    """Where the slices share ranks, a rank takes what it holds from
    itself: equal slices copy shard-locally, a replicated source serves
    each destination rank it contains, and a plan that cannot cut the
    heads raises."""
    same = head_plan(8, [0, 1], [0, 1])
    assert all(p.src == p.dst for ps in same.values() for p in ps)
    rep = head_plan(8, [0, 1], [1, 2], src_shards=1)
    assert [p.src for p in rep[1]] == [1] and [p.src for p in rep[2]] == [0]
    assert (rep[1][0].lo, rep[1][0].hi, rep[2][0].lo) == (0, 4, 4)
    with pytest.raises(ValueError, match="cannot cut"):
        head_plan(6, [0], [1, 2, 3, 4])


@pytest.mark.parametrize("arch,kw", [
    pytest.param("llama-3.1-8b", dict(tp=1, devices=[0, 1]),
                 id="llama-tp1-disjoint"),
    pytest.param("mamba2-2.7b", dict(tp=1, devices=[0, 1]),
                 id="mamba2-tp1-disjoint"),
    pytest.param("qwen3-moe-30b-a3b", dict(tp=2, devices=[0, 1, 2, 3]),
                 id="moe-tp2"),
    pytest.param("llama-3.1-8b-int8", dict(tp=2, devices=[0, 1, 2, 3]),
                 id="int8-tp2"),
])
def test_disjoint_factory_refuses_only_item_8(arch, kw):
    """A disjoint tp=1 slice builds (Mamba2 too), and so do MoE's 2-wide
    slices of a 4-rank world (experts over "model") and an int8 ring's
    2-wide slices (its scales cut with its kv heads), before any process
    group is touched: the factory refuses none of them."""
    if arch.endswith("-int8"):
        rc = dataclasses.replace(TREG[arch[:-5]].reduced(), kv_dtype="int8")
    else:
        rc = TREG[arch].reduced()
    assert callable(t_factory(rc, {}, device="cpu", **kw))
