"""Mesh-sliced serving in the port against the JAX package
(tests/test_mesh_parity.py in the port).

The port runs a slice SPMD: one process per rank of a
``torch.distributed`` world, each holding its shards.  Here the worlds
are spawned gloo worlds on the CPU (``_mesh_worlds.py``, no JAX in the
ranks), running the reduced llama in float32; the parent holds what they
return against the JAX package:

* the three head-sharded decode-attention wrappers at tp 2 and 4, fed
  DTensors and fed the model's local heads, against the JAX wrappers under ``shard_map`` on forced host devices (one
  subprocess, interpret mode), with a page boundary and head counts that
  do not divide (:48, :86, :122 of ``repro/kernels/decode_attention/
  ops.py``);
* dense and paged/verify forwards at tp 2 and 4 against the meshless
  JAX model, at ``TOL`` (tests/test_mesh_parity.py:224-272), also with a
  vocabulary of 256 that the embedding and head split;
* a tp=1 slice bit-exact with the meshless port, and 0 compiles warm
  (:177);
* tp=2 clusters (dense ring, paged speculation) against JAX meshless
  clusters at the same ``ClusterConfig(tp=2)``: bit-equal control plane
  and stream lengths, the same streams on both ranks, and every token
  within 0.05 of the JAX model's max logit; a sliced backend's pool
  drains (:371);
* ``MeshSlicer`` and ``mesh_fingerprint`` (:73, :111, :127).
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

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
from repro_torch.distributed import MeshSlicer
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import make_draft_config as t_make_draft
import _mesh_worlds as W
from _port_parity import (
    assert_same_run,
    forward_script,
    jax_forward,
    recording,
    replay_by_kind,
    replay_near_argmax,
    token_kinds,
)

# sharded reductions reassociate float sums (tests/test_mesh_parity.py:224)
TOL = dict(rtol=2e-4, atol=2e-5)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py:18, float32
MODEL = REGISTRY["llama-3.1-8b"]
TPS = (2, 4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Inputs, made once with numpy
# ---------------------------------------------------------------------------


def wrapper_cases(tp):
    """(id, kind, arrays): each wrapper at heads that divide tp (8/4) and
    heads that do not (6/3), over ragged ring rows and paged lengths on
    either side of a page boundary."""
    rng = np.random.default_rng(100 + tp)
    B, C, Dh, ps, P, Pmax = 3, 64, 16, 8, 24, 4
    cases = []
    for hq, hkv in ((8, 4), (6, 3)):
        q = rng.normal(size=(B, hq, Dh)).astype(np.float32)
        kc = rng.normal(size=(B, C, hkv, Dh)).astype(np.float32)
        vc = rng.normal(size=(B, C, hkv, Dh)).astype(np.float32)
        filled = np.array([C, C // 2, 5])
        slot_pos = np.where(np.arange(C)[None] < filled[:, None],
                            np.arange(C)[None], -1).astype(np.int32)
        q_pos = (filled - 1).astype(np.int32)
        cases.append((f"decode-tp{tp}-h{hq}-{hkv}", "decode",
                      (q, kc, vc, slot_pos, q_pos)))
        kp = rng.normal(size=(P, ps, hkv, Dh)).astype(np.float32)
        vp = rng.normal(size=(P, ps, hkv, Dh)).astype(np.float32)
        lengths = np.array([ps, ps + 1, 3 * ps - 1], np.int32)  # boundary
        perm = rng.permutation(P)
        bt = np.full((B, Pmax), -1, np.int32)
        for b, n in enumerate(lengths):
            bt[b, : -(-n // ps)] = perm[b * Pmax: b * Pmax + -(-n // ps)]
        for kind, T in (("paged_decode", 1), ("paged_verify", 3)):
            shape = (B, hq, Dh) if T == 1 else (B, T, hq, Dh)
            qp = rng.normal(size=shape).astype(np.float32)
            cases.append((f"{kind}-tp{tp}-h{hq}-{hkv}", kind,
                          (qp, kp, vp, bt, lengths)))
    return cases


JAX_WRAPPERS = r"""
import json, sys
import numpy as np
from repro.distributed.meshslice import MeshSlicer
from repro.kernels.decode_attention import ops

spec = json.load(open(sys.argv[1]))
arrays = np.load(sys.argv[2])
fns = {"decode": ops.decode_attention,
       "paged_decode": ops.paged_decode_attention,
       "paged_verify": ops.paged_verify_attention}
out = {}
for cid, kind, tp, n in spec:
    mesh = MeshSlicer().slice(tp)
    args = [arrays[f"{cid}/{j}"] for j in range(n)]
    out[cid] = np.asarray(fns[kind](*args, mesh=mesh))
np.savez(sys.argv[3], **out)
"""


# ---------------------------------------------------------------------------
# The worlds, started together; each test waits for the part it reads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rc = dataclasses.replace(MODEL.reduced(), dtype="float32")
    rc256 = dataclasses.replace(rc, vocab_size=256)
    params = M.init_params(rc, jax.random.key(0))
    params256 = M.init_params(rc256, jax.random.key(0))
    dcfg = make_draft_config(rc)
    dparams = M.init_params(dcfg, jax.random.key(1))
    tmp = tmp_path_factory.mktemp("mesh")

    # the JAX sharded wrappers on 4 forced host devices, in a subprocess
    cases = {tp: wrapper_cases(tp) for tp in TPS}
    flat = [c for tp in TPS for c in cases[tp]]
    spec = [(cid, kind, int(cid.split("-tp")[1][0]), len(a))
            for cid, kind, a in flat]
    (tmp / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp / "in.npz", **{f"{cid}/{j}": x for cid, _, a in flat
                                for j, x in enumerate(a)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_WRAPPERS, str(tmp / "spec.json"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    tmodel = TREG["llama-3.1-8b"]
    tpred = t_build_predictor(tmodel, TA100, TA100.freq_levels_2,
                              kv_cap=400_000)
    tpred_spec = t_build_predictor(tmodel, TA100, TA100.freq_levels_2,
                                   kv_cap=400_000, spec_k=W.SPEC_K)
    trc = dataclasses.replace(tmodel.reduced(), dtype="float32")
    scripts = {"v257": forward_script(rc), "v256": forward_script(rc256)}
    variants = [("v257", trc, _np(params), scripts["v257"]),
                ("v256", dataclasses.replace(trc, vocab_size=256),
                 _np(params256), scripts["v256"])]
    worlds = {
        "tp1": W.start_world(W.tp1_rank, 1, tmp, trc, _np(params), tpred),
        "clusters": W.start_world(
            W.cluster_rank, 2, tmp, trc, _np(params), t_make_draft(trc),
            _np(dparams), {"ring": tpred, "spec": tpred_spec}),
    }
    for tp in TPS:
        worlds[tp] = W.start_world(W.mesh_rank, tp, tmp, cases[tp],
                                   variants)

    def jax_wrappers():
        stdout, stderr = jax_proc.communicate(timeout=W.JOIN_TIMEOUT_S)
        assert jax_proc.returncode == 0, stderr[-3000:]
        return dict(np.load(tmp / "out.npz"))

    yield SimpleNamespace(
        rc=rc, params=params, rc256=rc256, params256=params256, dcfg=dcfg,
        dparams=dparams, cases=cases, scripts=scripts, worlds=worlds,
        jax_wrappers=jax_wrappers,
    )
    if jax_proc.poll() is None:
        jax_proc.kill()
    for w in worlds.values():  # a test that failed early leaves none alive
        for p in w.procs:
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# The sharded wrappers against the JAX sharded wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("kind", ["decode", "paged_decode", "paged_verify"])
@pytest.mark.parametrize("heads", ["h8-4", "h6-3"])
@pytest.mark.parametrize("route", W.ROUTES)
def test_sharded_wrapper_matches_jax_shard_map(ref, tp, kind, heads, route):
    """DTensors into the wrapper, and the model's route (local heads
    into its sharded branch), against the JAX wrapper under
    ``shard_map``."""
    cid = f"{kind}-tp{tp}-{heads}"
    want = ref.jax_wrappers()[cid]
    divides = heads == "h8-4"
    for rank, res in enumerate(ref.worlds[tp].result()):
        got, sharded = res["wrappers"][cid, route]
        assert sharded == divides, (rank, sharded)
        np.testing.assert_allclose(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("kernel", ["ring", "paged"])
def test_sharded_branch_counts_only_the_launches_made(monkeypatch, kernel):
    """``sharded_launches`` takes the launches the unsharded wrapper made
    inside the sharded branch, from the counters at the launch sites: a
    call that returns before its launch (an empty batch) adds nothing.
    The wrapper here stands in for one, bumping the launch-site counter
    only when told to launch."""
    from repro_torch.kernels.decode_attention import ops

    monkeypatch.setattr(ops, "launches", 0)
    monkeypatch.setattr(ops, "paged_launches", {})
    monkeypatch.setattr(ops, "sharded_launches", {})
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))

    def stand_in(q, k, v, *rest, launch):
        if launch and kernel == "ring":
            ops.launches += 1
        elif launch:
            ops.paged_launches[3] = ops.paged_launches.get(3, 0) + 1
        return q

    q, kv = np.zeros((0, 4, 8)), np.zeros((0, 16, 2, 8))
    ops.on_local_heads(stand_in, q, kv, kv, mesh=mesh, launch=False)
    assert ops.sharded_launches == {}
    for _ in range(2):
        ops.on_local_heads(stand_in, q, kv, kv, mesh=mesh, launch=True)
    assert ops.sharded_launches == {("stand_in", 2): 2}
    width1 = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    with pytest.raises(ValueError, match="width 1"):
        ops.on_local_heads(stand_in, q, kv, kv, mesh=width1, launch=True)


# ---------------------------------------------------------------------------
# Forward parity against the meshless JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("vocab", ["v257", "v256"])
def test_forward_parity(ref, tp, vocab):
    """Dense and paged/verify logits of every rank within ``TOL`` of the
    meshless JAX model.  At tp=2 the reduced config's 4/2 heads shard;
    at tp=4 its 2 kv heads do not and attention stays replicated, while
    d_ff and (v256) the vocabulary split."""
    rc, params = ((ref.rc, ref.params) if vocab == "v257"
                  else (ref.rc256, ref.params256))
    want = jax_forward(M, rc, params, ref.scripts[vocab])
    ranks = ref.worlds[tp].result()
    assert len(ranks) == tp
    for rank, res in enumerate(ranks):
        assert len(res["forward"][vocab]) == len(want)
        for step, (got, w) in enumerate(zip(res["forward"][vocab], want)):
            assert got.shape == w.shape, (rank, step)
            np.testing.assert_allclose(got, w, **TOL,
                                       err_msg=f"rank {rank} step {step}")


# ---------------------------------------------------------------------------
# Clusters
# ---------------------------------------------------------------------------


def test_tp1_mesh_cluster_bit_exact_and_no_steady_recompiles(ref):
    r_plain, r_mesh, warm_recompiles, widths, _ = \
        ref.worlds["tp1"].result()[0]
    assert widths and all(w == (1, 1) for w in widths)
    assert all(r.finished for r in r_plain + r_mesh)
    for a, b in zip(r_plain, r_mesh):
        assert a.output_tokens == b.output_tokens, f"req {a.rid} diverged"
        assert a.t_finish == b.t_finish
    assert warm_recompiles == 0


def _jax_cluster(ref, pred, factory, **kw):
    reqs = W.workload(JS, ref.rc.vocab_size)
    m = JS.PDCluster(W.cluster_cfg(JS, MODEL, A100, pred, tp=2,
                                   backend_factory=factory, **kw)).run(reqs)
    return reqs, m


def test_tp2_ring_cluster_matches_jax_meshless_cluster(ref):
    pred = build_predictor(MODEL, A100, A100.freq_levels_2, kv_cap=400_000)
    ra, ma = _jax_cluster(ref, pred, make_real_backend_factory(
        ref.rc, ref.params, slots=8, max_len=W.MAX_LEN))
    ranks = ref.worlds["clusters"].result()
    (rb, mb), (rc_, _) = ranks[0]["ring"], ranks[1]["ring"]
    assert ma.finished_frac() == mb.finished_frac() == 1.0
    assert_same_run(ra, ma, rb, mb)
    for a, b in zip(rb, rc_):
        assert a.output_tokens == b.output_tokens, f"ranks differ, {a.rid}"
        assert len(a.output_tokens) == a.decode_len + 1
    replay_near_argmax(ref.rc, ref.params, rb, W.MAX_LEN)


def test_tp2_spec_cluster_matches_jax_meshless_cluster(ref):
    pred = build_predictor(MODEL, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=W.SPEC_K)
    factory, la = recording(make_real_backend_factory(
        ref.rc, ref.params, slots=8, max_len=W.MAX_LEN, paged=True,
        page_size=16, spec_k=W.SPEC_K, draft_cfg=ref.dcfg,
        draft_params=ref.dparams))
    ra, ma = _jax_cluster(ref, pred, factory, paged=True, kv_page_size=16,
                          spec_decode=True, spec_k=W.SPEC_K)
    ranks = ref.worlds["clusters"].result()
    (rb, mb, lb), (rc_, _, lc) = ranks[0]["spec"], ranks[1]["spec"]
    assert ma.finished_frac() == 1.0 and mb.spec_iterations() > 0
    assert_same_run(ra, ma, rb, mb)
    for a, b in zip(ra, rb):
        assert (a.spec_iters, a.spec_accepted) == (b.spec_iters,
                                                   b.spec_accepted)
    assert la == lb == lc and any(a > 0 for _, a in lb)
    for a, b in zip(rb, rc_):
        assert a.output_tokens == b.output_tokens, f"ranks differ, {a.rid}"
        assert len(a.output_tokens) == a.decode_len + 1
    replay_by_kind({"target": (ref.rc, ref.params),
                    "draft": (ref.dcfg, ref.dparams)},
                   rb, token_kinds(rb, lb), W.MAX_LEN)


def test_sharded_backend_pool_drains(ref):
    """Prefill → insert (the shard-local P→D handoff) → decode → release
    on a tp=2 backend: the host-side pool drains empty on both ranks."""
    for res in ref.worlds["clusters"].result():
        assert [len(t) for t in res["drain"]] == [3, 3]


# ---------------------------------------------------------------------------
# Slicer and fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 4])
def test_mesh_slicer_round_robin_restart_and_fingerprint(ref, world):
    ranks = ref.worlds["tp1" if world == 1 else world].result()
    for got in [res[-1] if world == 1 else res["slicer"] for res in ranks]:
        assert got["n"] == world
        assert got["names"] == ("data", "model")
        assert got["fp_equal"] and got["fp_other"]
        if world == 1:  # every slice wraps onto the one rank
            assert got["a"] == got["b"] == (0,)
            assert got["fp_wrap"] and got["c_is_a"]
        else:  # disjoint while the pool lasts, then restart at rank 0
            assert (got["a"], got["b"]) == ((0, 1), (2, 3))
            assert got["shape"] == (1, 2) and not got["fp_wrap"]
            assert got["c_is_a"]
            assert got["restart"] == (0, 1, 2)


def test_mesh_slicer_rejects_bad_tp():
    sl = MeshSlicer([0, 1], device_type="cpu")
    with pytest.raises(ValueError, match="tp must be"):
        sl.slice(0)
    with pytest.raises(ValueError, match="exceeds"):
        sl.slice(3)
    with pytest.raises(ValueError, match="at least one device"):
        MeshSlicer([], device_type="cpu")
    with pytest.raises(RuntimeError, match="init_world"):
        MeshSlicer(device_type="cpu")  # no world joined in this process
