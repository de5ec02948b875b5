"""Mamba2 SSD heads over ``"model"`` in the port against the JAX package
(the JAX rule: ``ssd_head_pspec``, ``repro/distributed/context.py:54-63``,
used at ``repro/models/model.py:342-346``).

The port runs a slice SPMD, one process per rank, each holding its
shards: ``in_proj`` and ``conv_w`` cut by segment (its heads' z, x and
dt columns, B and C whole), the SSD heads' ``A_log``/``dt_bias``/``D``
and ``gnorm`` channels, ``out_proj`` row-parallel, and a cache whose SSM
state holds its heads and whose conv tail its x channels beside B and C.
The worlds are spawned gloo worlds on the CPU (``_mesh_worlds.py``, no
JAX in the ranks) on the reduced mamba2 in float32, with x/B/C rescaled
(``_mamba_weights.live_state``) so that the scan and the state reach the
logits:

* prefill and decode logits at tp 2 and 4 against the meshless JAX
  model at ``TOL`` (tests/test_mesh_parity.py:224), also with 6 SSD
  heads, which split at tp 2 and stay whole at tp 4 (the replicated
  fallback);
* the gated norm taken per rank (a planted fault) misses ``TOL``: the
  norm's mean square is over the whole d_inner;
* a tp=2 dense cluster against the JAX meshless cluster at the same
  ``ClusterConfig(tp=2)``: bit-equal control plane and stream lengths,
  the same streams on both ranks, each token within 0.05 of the JAX max
  logit; a 3-rank world with the prefill at tp=1 on rank 0 and the
  decode at tp=2 on ranks 1-2, where the handoff cuts the SSM state's
  heads and the conv tail's x channels;
* with no world: the cut of the JAX tree at widths 2 and 4 put back
  together by each leaf's rule, the init on a mesh against the cut of
  the meshless draw, and the handoff's pieces of a conv tail.
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
from repro.serving.realengine import make_real_backend_factory
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.power import A100 as TA100
from repro_torch.distributed import handoff as HO
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import mesh_context
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.cluster import build_predictor as t_build_predictor
import _mesh_worlds as W
from _mamba_weights import live_state
from _port_parity import (
    assert_same_run,
    forward_script,
    jax_forward,
    replay_near_argmax,
)

TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_mesh.py: sharded sums
TPS = (2, 4)
ARCH = "mamba2-2.7b"
MAMBA = REGISTRY[ARCH]
UNEQUAL = (1, 2)  # (prefill, decode) slice widths of the 3-rank world


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _six_heads(cfg):
    """The reduced config with 6 SSD heads of 32 (d_inner 192): they
    split over 2 ranks, not over 4."""
    return dataclasses.replace(cfg, mamba=dataclasses.replace(
        cfg.mamba, expand=3, head_dim=32))


def _configs(reg):
    rc = dataclasses.replace(reg[ARCH].reduced(), dtype="float32")
    return {"mamba": rc, "mamba6": _six_heads(rc)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_mamba")
    cfgs, tcfgs = _configs(REGISTRY), _configs(TREG)
    params = {name: live_state(_np(M.init_params(rc, jax.random.key(0))), rc)
              for name, rc in cfgs.items()}
    script = forward_script(cfgs["mamba"], paged=False)
    variants = [(name, tcfgs[name], params[name], script) for name in cfgs]
    tmodel = TREG[ARCH]
    pred = t_build_predictor(tmodel, TA100, TA100.freq_levels_2,
                             kv_cap=400_000)
    bank = {(TA100.name, tp): t_build_predictor(
        tmodel, TA100, TA100.freq_levels_2, kv_cap=400_000, tp=tp)
        for tp in set(UNEQUAL)}
    worlds = {tp: W.start_world(W.forward_rank, tp, tmp, variants)
              for tp in TPS}
    worlds["planted"] = W.start_world(W.planted_forward_rank, 2, tmp,
                                      variants[:1])
    worlds["cluster"] = W.start_world(
        W.mixer_cluster_rank, 2, tmp,
        [("mamba", ARCH, tcfgs["mamba"], params["mamba"], "dense")],
        {"mamba": pred})
    worlds["unequal"] = W.start_world(
        W.unequal_rank, 3, tmp, tcfgs["mamba"], params["mamba"], UNEQUAL,
        bank, ARCH)
    want = {}

    def jax_logits(name):
        if name not in want:
            want[name] = jax_forward(M, cfgs[name], params[name], script)
        return want[name]

    yield SimpleNamespace(cfgs=cfgs, tcfgs=tcfgs, params=params,
                          worlds=worlds, jax_logits=jax_logits)
    for w in worlds.values():  # a test that failed early leaves none alive
        for p in w.procs:
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# Forward parity against the meshless JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", ["mamba", "mamba6"])
def test_forward_parity(ref, tp, name):
    """Prefill and 3 decode steps of every rank within ``TOL`` of the
    meshless JAX model: 8 SSD heads split at both widths, 6 at tp 2 (3
    a rank) and stay whole at tp 4."""
    want = ref.jax_logits(name)
    ranks = ref.worlds[tp].result()
    assert len(ranks) == tp
    for rank, res in enumerate(ranks):
        assert len(res[name]) == len(want)
        for step, (got, w) in enumerate(zip(res[name], want)):
            np.testing.assert_allclose(got, w, **TOL,
                                       err_msg=f"rank {rank} step {step}")


def test_gated_norm_taken_per_rank_misses(ref):
    """The planted fault: each rank normalises its own d_inner channels
    by their own mean square.  Every step's logits then miss ``TOL``
    by far, so :func:`test_forward_parity` sees the norm's sum over
    ``"model"``."""
    want = ref.jax_logits("mamba")
    for res in ref.worlds["planted"].result():
        for got, w in zip(res["mamba"], want):
            err = float(np.abs(got - w).max())
            assert err > 100 * (TOL["atol"] + TOL["rtol"] * np.abs(w).max())


# ---------------------------------------------------------------------------
# Clusters
# ---------------------------------------------------------------------------


def test_tp2_dense_cluster_matches_jax_meshless_cluster(ref):
    rc, params = ref.cfgs["mamba"], ref.params["mamba"]
    pred = build_predictor(MAMBA, A100, A100.freq_levels_2, kv_cap=400_000)
    reqs = W.workload(JS, rc.vocab_size)
    ma = JS.PDCluster(W.cluster_cfg(
        JS, MAMBA, A100, pred, tp=2,
        backend_factory=make_real_backend_factory(
            rc, params, slots=8, max_len=W.MAX_LEN))).run(reqs)
    ranks = ref.worlds["cluster"].result()
    (rb, mb, widths), (rc_, *_) = ranks[0]["mamba"], ranks[1]["mamba"]
    assert ma.finished_frac() == mb.finished_frac() == 1.0
    assert widths == [2, 2]
    assert_same_run(reqs, ma, rb, mb)
    for a, b in zip(rb, rc_):
        assert a.output_tokens == b.output_tokens, f"ranks differ, {a.rid}"
        assert len(a.output_tokens) == a.decode_len + 1
    replay_near_argmax(rc, params, rb, W.MAX_LEN)


def test_p_tp1_to_d_tp2_matches_jax_meshless_cluster(ref):
    """Prefill at tp=1 on rank 0, decode at tp=2 on ranks 1-2: each
    decode rank takes its half of the SSM state's heads and of the conv
    tail's x channels from rank 0, and B and C whole."""
    rc, params = ref.cfgs["mamba"], ref.params["mamba"]
    pred = {tp: build_predictor(MAMBA, A100, A100.freq_levels_2,
                                kv_cap=400_000, tp=tp) for tp in UNEQUAL}
    reqs = W.workload(JS, rc.vocab_size)
    ma = JS.PDCluster(W.cluster_cfg(
        JS, MAMBA, A100, None,
        prefill_fleet=[JS.InstanceSpec(A100, UNEQUAL[0])],
        decode_fleet=[JS.InstanceSpec(A100, UNEQUAL[1])],
        predictor_bank={(A100.name, tp): p for tp, p in pred.items()},
        backend_factory=make_real_backend_factory(
            rc, params, slots=8, max_len=W.MAX_LEN))).run(reqs)
    ranks = ref.worlds["unequal"].result()
    rb, mb, facts = ranks[0]
    assert ma.finished_frac() == mb.finished_frac() == 1.0
    assert_same_run(reqs, ma, rb, mb)
    for rank, (r_, _, f) in enumerate(ranks):
        assert f["ranks"] == [("prefill", (0,)), ("decode", (1, 2))]
        assert f["crossed"] >= len(rb) and f["local_handoffs"] == 0
        for a, b in zip(rb, r_):
            assert a.output_tokens == b.output_tokens, \
                f"rank {rank} differs, {a.rid}"
    replay_near_argmax(rc, params, rb, W.MAX_LEN)


# ---------------------------------------------------------------------------
# Cuts, init and the handoff's pieces, no world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", ["mamba", "mamba6"])
def test_cut_jax_tree_joins_back(ref, tp, name):
    """The bridged JAX tree cut at width ``tp`` (``shard_params``),
    each leaf's shards put back together by its rule, is the full leaf;
    a leaf the rules keep whole is the same on every rank, and a split
    one is this rank's part of the heads (or all of them where they do
    not divide)."""
    rc = ref.tcfgs[name]
    full = params_from_jax(ref.params[name], device="cpu")
    cuts = [SH.shard_params(full, rc, W.FakeMesh(tp, i)) for i in range(tp)]
    nh = rc.mamba.n_heads(rc.d_model)
    split = W.assert_cuts_join(rc, full, cuts)
    assert bool(split) == (nh % tp == 0)
    local = cuts[0]["blocks"]["layer_0"]["mamba"]
    heads = nh // tp if nh % tp == 0 else nh
    assert local["A_log"].shape[-1] == heads
    assert local["out_proj"].shape[-2] == heads * rc.mamba.head_dim


@pytest.mark.parametrize("tp", TPS)
def test_init_on_a_mesh_is_the_cut_of_the_meshless_draw(ref, tp):
    """``init_params(mesh=)`` keeps each rank's shards of the same draws,
    and a cache allocated in the mesh context is at its local widths
    (``place_serving_state`` accepts it; the meshless one it refuses)."""
    rc = ref.tcfgs["mamba"]
    full = TM.init_params(rc, torch.Generator().manual_seed(3), device="cpu")
    for i in range(tp):
        mesh = W.FakeMesh(tp, i)
        got = TM.init_params(rc, torch.Generator().manual_seed(3),
                             device="cpu", mesh=mesh)
        want = SH.shard_params(full, rc, mesh)
        for (path, a), (_, b) in zip(W.tree_leaves(got), W.tree_leaves(want)):
            assert a.shape == b.shape and torch.equal(a, b), path
        with mesh_context(mesh):
            cache = TM.init_cache(rc, 2, 32, device="cpu")
        entry = cache["layer_0"]
        nh, P, N = 8 // tp, rc.mamba.head_dim, rc.mamba.d_state
        assert entry["ssm"].shape == (1, 2, nh, P, N)
        assert entry["conv"].shape == (1, 2, rc.mamba.d_conv - 1,
                                       nh * P + 2 * N)
        SH.place_serving_state(rc, full, [cache], mesh)
        with pytest.raises(ValueError, match="mesh_context"):
            SH.place_serving_state(rc, full, [TM.init_cache(
                rc, 2, 32, device="cpu")], mesh)


def test_handoff_cuts_the_conv_tail_by_channel(ref):
    """From one source rank to a 2-wide slice: each destination rank
    takes its half of the SSM heads and of the conv tail's x channels,
    and B and C whole, from the source's offsets."""
    rc = ref.tcfgs["mamba"]
    src = TM.init_cache(rc, 1, 32, device="meta")
    leaves = {leaf.key: leaf for leaf in HO.leaves_of(rc, src)}
    P, N, nh = rc.mamba.head_dim, rc.mamba.d_state, 8
    conv, ssm = leaves["conv"], leaves["ssm"]
    assert conv.cut == SH.Segments(3, ((nh * P, nh), (2 * N, 0)), "ssm")
    assert ssm.cut == SH.Segments(2, ((nh, nh),), "ssm")
    plan = HO.head_plan(nh, [0], [1, 2], 1, 2)
    full = torch.arange(nh * P + 2 * N).reshape(1, 1, 1, -1)
    for j, d in enumerate((1, 2)):
        moves = [(s, dst, take(full), put)
                 for s, dst, take, put in HO._transfers(
                     conv, {d: plan[d]}, [0], 1, 2)]
        assert all(s == 0 and dst == d for s, dst, _, _ in moves)
        out = torch.empty(1, 1, 1, nh // 2 * P + 2 * N, dtype=full.dtype)
        for _, _, got, put in moves:
            put(out).copy_(got)
        want = torch.cat([full[..., j * nh // 2 * P: (j + 1) * nh // 2 * P],
                          full[..., nh * P:]], -1)
        assert torch.equal(out, want)
