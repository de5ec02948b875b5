"""int8 serving on a mesh slice in the port against the JAX package:
int8 weights, the int8 ring and int8 MoE dispatch on a ``"model"`` axis
wider than 1 (the JAX package places the ``{"q8", "sc"}`` leaves under
GSPMD, ``repro/distributed/sharding.py:125-127``).

A scale ``sc`` is placed as its codes ``q8`` are with the input dim
removed (``sharding.scale_placement``), and ``quantize_params`` on a
slice takes the absmax of a leaf whose input dim is cut (row-parallel
``wo``, ``w_out``, ``out_proj``; a Mamba2 ``conv_w``'s channels) as its
maximum over ``"model"``.  The worlds are spawned gloo worlds on the CPU
(``_mesh_worlds.py``, no JAX in the ranks), on the reduced configs in
float32:

* every quantized leaf of reduced llama, qwen3-moe (4 and 6 experts),
  mamba2 (8 and 6 SSD heads) and jamba quantized on the slice at tp 2
  and 4 equals the cut of the meshless JAX ``quantize_params`` tree,
  codes and scales bitwise, and the ranks' shards join back into it
  (the heads, experts and vocabularies that do not divide a width stay
  whole);
* dense and paged/verify logits on those shards at tp 2 and 4 against
  the meshless JAX int8 model at ``TOL``, with int8 weights and with
  the int8 ring too;
* with no world: the sliced int8 MoE layer, its ranks' slabs joined as
  the gather joins them, equals the meshless int8 branch bitwise at the
  capacity factors of ``test_int8_moe_dispatch_matches``, and what it
  gathers is int8;
* tp=2 clusters (llama with int8 weights and ring over the dense ring,
  qwen3-moe with int8 dispatch over the paged pool) against the JAX
  meshless cluster at the same ``ClusterConfig(tp=2)``: bit-equal
  control plane and stream lengths, the same streams on both ranks,
  every token within 0.05 of the JAX max logit;
* the dry-run's int8 variants on the production mesh are ``ok``: int8
  weights hold fewer bytes a rank than bf16, and the step's collectives
  are the bf16 step's (the load-time absmax reduce runs before it).
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
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as TL
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
LLAMA, MOE = "llama-3.1-8b", "qwen3-moe-30b-a3b"
MAMBA, JAMBA = "mamba2-2.7b", "jamba-v0.1-52b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _int8(cfg, kv=False, weights=True, dispatch=False):
    kw = {}
    if weights:
        kw["weight_dtype"] = "int8"
    if kv:
        kw["kv_dtype"] = "int8"
    if dispatch:
        kw["moe"] = dataclasses.replace(cfg.moe, dispatch_dtype="int8")
    return dataclasses.replace(cfg, **kw)


def _configs(reg):
    """{variant: (int8 config, the float weights' key)}: reduced llama
    (4/2 heads: split at tp 2, whole at tp 4; vocabulary 257, whole at
    both), with int8 weights and with the int8 ring too; qwen3-moe with
    4 experts and with 6 (split at tp 2, whole at tp 4); mamba2 with 8
    SSD heads and with 6 (likewise); jamba."""
    def reduced(arch):
        return dataclasses.replace(reg[arch].reduced(), dtype="float32")

    moe, mamba = reduced(MOE), reduced(MAMBA)
    return {
        "llama": (_int8(reduced(LLAMA)), "llama"),
        "llama-kv8": (_int8(reduced(LLAMA), kv=True), "llama"),
        "moe": (_int8(moe), "moe"),
        "moe6": (_int8(dataclasses.replace(moe, moe=dataclasses.replace(
            moe.moe, num_experts=6))), "moe6"),
        "mamba": (_int8(mamba), "mamba"),
        "mamba6": (_int8(dataclasses.replace(mamba, mamba=dataclasses.replace(
            mamba.mamba, expand=3, head_dim=32))), "mamba6"),
        "jamba": (_int8(reduced(JAMBA)), "jamba"),
    }


# the variants whose forwards run (dense, and paged/verify where the
# config has the paged pool and float KV); the others are cut only
SCRIPTS = {"llama": True, "llama-kv8": False, "moe": True, "mamba": False,
           "jamba": False}
CUTS = ["llama", "moe", "moe6", "mamba", "mamba6", "jamba"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_int8")
    cfgs, tcfgs = _configs(REGISTRY), _configs(TREG)
    floats = {}
    for name, (rc, key) in cfgs.items():
        if key not in floats:
            p = _np(M.init_params(rc, jax.random.key(3)))
            floats[key] = live_state(p, rc) if rc.mamba else p
    scripts = {name: forward_script(cfgs[name][0], paged=paged)
               for name, paged in SCRIPTS.items()}
    variants = [(name, tcfgs[name][0], floats[key], scripts.get(name))
                for name, (_, key) in cfgs.items()]
    worlds = {tp: W.start_world(W.int8_rank, tp, tmp, variants)
              for tp in TPS}
    # the tp=2 clusters: llama from the JAX-quantized tree (cut by the
    # factory), qwen3-moe's float tree with int8 dispatch
    llama = cfgs["llama-kv8"][0]
    qllama = _np(M.quantize_params(floats["llama"]))
    moe_rc = _int8(dataclasses.replace(REGISTRY[MOE].reduced(),
                                       dtype="float32"),
                   weights=False, dispatch=True)
    moe_trc = _int8(dataclasses.replace(TREG[MOE].reduced(),
                                        dtype="float32"),
                    weights=False, dispatch=True)
    preds = {name: t_build_predictor(TREG[arch], TA100, TA100.freq_levels_2,
                                     kv_cap=400_000)
             for name, arch in (("llama8", LLAMA), ("moe8", MOE))}
    worlds["cluster"] = W.start_world(
        W.mixer_cluster_rank, 2, tmp,
        [("llama8", LLAMA, tcfgs["llama-kv8"][0], qllama, "dense"),
         ("moe8", MOE, moe_trc, floats["moe"], "acceptance")], preds)
    want = {}

    def jax_logits(name):
        if name not in want:
            rc, key = cfgs[name]
            want[name] = jax_forward(M, rc, M.quantize_params(floats[key]),
                                     scripts[name])
        return want[name]

    yield SimpleNamespace(cfgs=cfgs, tcfgs=tcfgs, floats=floats,
                          worlds=worlds, jax_logits=jax_logits,
                          clusters={"llama8": (llama, qllama),
                                    "moe8": (moe_rc, floats["moe"])})
    for w in worlds.values():  # a test that failed early leaves none alive
        for p in w.procs:
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# Shards quantized on the slice against the cut JAX tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", CUTS)
def test_shards_quantized_on_the_slice_equal_the_cut_jax_tree(ref, tp, name):
    """Codes and scales bitwise: every rank's shards quantized on the
    slice are the cut of the meshless JAX ``quantize_params`` tree, and
    joined by each leaf's rule they give the whole tree back.  A
    row-parallel leaf's scales (their max over ``"model"``) are whole on
    every rank; a column-parallel one's are cut with its columns."""
    trc, key = ref.tcfgs[name]
    full = params_from_jax(_np(M.quantize_params(ref.floats[key])),
                           device="cpu")
    ranks = ref.worlds[tp].result()
    shards = [{tuple(p.split("/")): torch.from_numpy(a)
               for p, a in res[name]["shards"].items()} for res in ranks]
    for i, got in enumerate(shards):
        cut = dict(W.tree_leaves(SH.shard_params(full, trc,
                                                 W.FakeMesh(tp, i))))
        assert set(got) == set(cut)
        for path, leaf in cut.items():
            assert got[path].dtype == leaf.dtype, path
            assert torch.equal(got[path], leaf), (i, path)
    cuts = []
    for got in shards:
        tree = {}
        for path, leaf in got.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        cuts.append(tree)
    split = W.assert_cuts_join(trc, full, cuts)
    scales = {p[-3:-1]: SH.leaf_placement(trc, p, W.FakeMesh(tp, 0))
              for p, _ in W.tree_leaves(full) if p[-1] == "sc"}
    for row_parallel in (("attn", "wo"), ("mlp", "w_out"),
                         ("mamba", "out_proj"), ("mamba", "conv_w")):
        if row_parallel in scales:
            assert scales[row_parallel] == SH.Replicate(), row_parallel
    if name == "llama":  # 2 kv heads: wq's columns split at tp 2 only
        assert (("blocks", "layer_0", "attn", "wq", "sc") in split) == \
            (tp == 2)
    if name in ("moe", "moe6"):  # experts (and their scales) split on E
        E = trc.moe.num_experts
        assert (("blocks", "layer_0", "moe", "w_out", "sc") in split) == \
            (E % tp == 0)


# ---------------------------------------------------------------------------
# Forwards on those shards against the meshless JAX int8 model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_int8_forward_parity(ref, tp, name):
    """Every rank's logits within ``TOL`` of the meshless JAX model on
    its own quantized tree: dense prefill and decode (int8 weights, and
    with the int8 ring for ``llama-kv8``), and for llama and qwen3-moe
    also paged prefill, decode and a verify window."""
    want = ref.jax_logits(name)
    ranks = ref.worlds[tp].result()
    assert len(ranks) == tp
    for rank, res in enumerate(ranks):
        got = res[name]["logits"]
        assert len(got) == len(want)
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"rank {rank} step {step}")


# ---------------------------------------------------------------------------
# The sliced int8 MoE layer, no world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("T,E,k,cf", [(96, 8, 2, 4.0), (64, 8, 2, 1.0),
                                      (8, 128, 8, 1.25)],
                         ids=["T96-E8-cf4", "T64-E8-cf1-drops",
                              "T8-E128-k8-C1"])
def test_sliced_int8_dispatch_equals_the_meshless_int8_branch(n, T, E, k,
                                                              cf):
    """``moe_ffn_sorted`` with ``dispatch_dtype="int8"`` on each of ``n``
    ranks' experts, the ranks' slabs joined as the gather joins them:
    the meshless int8 branch's output and aux bitwise (drops included),
    and every tensor gathered is int8: codes and row scales packed,
    d + 4 bytes a row."""
    rng = np.random.default_rng(8)
    d, ffe = 32, 16
    x, router, *w = [torch.from_numpy(a) for a in (
        [rng.normal(size=(T, d)).astype(np.float32),
         (rng.normal(size=(d, E)) * 0.5).astype(np.float32)]
        + [(rng.normal(size=s) * 0.1).astype(np.float32)
           for s in ((E, d, ffe), (E, d, ffe), (E, ffe, d))])]
    kw = dict(top_k=k, capacity_factor=cf, dispatch_dtype="int8")
    want, aux = TL.moe_ffn_sorted(x, router, *w, **kw)
    assert cf > 1 or int(aux["dropped"]) > 0
    m = E // n
    slabs, dtypes = [None] * n, []

    def run(i, gather):
        return TL.moe_ffn_sorted(
            x, router, *(t[i * m:(i + 1) * m] for t in w),
            expert_shard=TL.ExpertShard(first=i * m, gather=gather), **kw)

    for i in range(n):  # each rank's slab, as it would send it
        def keep(ye, i=i):
            slabs[i] = ye
            return ye.new_zeros((n * ye.shape[0], ye.shape[1]))
        run(i, keep)
    assert all(s.dtype == torch.int8 and s.shape[1] == d + 4
               for s in slabs)

    def joined(ye):
        dtypes.append(ye.dtype)
        return torch.cat(slabs)

    for i in range(n):
        got, got_aux = run(i, joined)
        assert torch.equal(got, want), i
        for key in aux:
            assert torch.equal(got_aux[key], aux[key]), key
    assert dtypes == [torch.int8] * n


def test_packed_rows_round_trip_bitwise():
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(rng.normal(size=(7, 12)).astype(np.float32))
    codes, sc = TL.quantize(rows, -1)
    got_codes, got_sc = TL.unpack_rows(TL.pack_rows(codes, sc))
    assert torch.equal(got_codes, codes) and torch.equal(got_sc, sc)


# ---------------------------------------------------------------------------
# tp=2 int8 clusters against the JAX meshless cluster
# ---------------------------------------------------------------------------


def _cluster_parity(ref, name, arch, scenario):
    rc, params = ref.clusters[name]
    model = REGISTRY[arch]
    pred = build_predictor(model, A100, A100.freq_levels_2, kv_cap=400_000)
    if scenario == "dense":
        reqs = W.workload(JS, rc.vocab_size)
        ccfg = W.cluster_cfg(JS, model, A100, pred, tp=2,
                             backend_factory=make_real_backend_factory(
                                 rc, params, slots=8, max_len=W.MAX_LEN))
    else:
        reqs = W.acceptance_workload(JS, rc.vocab_size)
        ccfg = W.acceptance_cfg(JS, model, A100, pred,
                                backend_factory=make_real_backend_factory(
                                    rc, params, slots=8, max_len=W.MAX_LEN,
                                    paged=True, page_size=16))
    ma = JS.PDCluster(ccfg).run(reqs)
    ranks = ref.worlds["cluster"].result()
    (rb, mb, widths), (rc_, *_) = ranks[0][name], ranks[1][name]
    assert ma.finished_frac() == mb.finished_frac() == 1.0
    assert widths == ([2, 2] if scenario == "dense" else [2])
    assert_same_run(reqs, ma, rb, mb)
    for a, b in zip(rb, rc_):
        assert a.output_tokens == b.output_tokens, f"ranks differ, {a.rid}"
        assert len(a.output_tokens) == a.decode_len + 1
    replay_near_argmax(rc, params, rb, W.MAX_LEN)


def test_tp2_int8_ring_cluster_matches_jax_meshless_cluster(ref):
    """llama with int8 weights (the JAX-quantized tree, cut by the
    factory) and an int8 ring over the dense ring at tp=2."""
    _cluster_parity(ref, "llama8", LLAMA, "dense")


def test_tp2_int8_dispatch_moe_cluster_matches_jax_meshless_cluster(ref):
    """qwen3-moe with int8 dispatch over the paged pool at tp=2 (the JAX
    package's acceptance scenario), its experts split."""
    _cluster_parity(ref, "moe8", MOE, "acceptance")


# ---------------------------------------------------------------------------
# The dry-run's int8 variants on the production mesh
# ---------------------------------------------------------------------------

_BF16 = {}


def _bf16_cell(arch):
    if arch not in _BF16:
        _BF16[arch] = D.run_cell(arch, "decode_32k", False, verbose=False)
    return _BF16[arch]


@pytest.mark.parametrize("arch,variant", [
    ("minicpm-2b", {"weight_dtype": "int8"}),
    (MOE, {"kv_dtype": "int8"}),
    (MOE, {"dispatch_dtype": "int8"}),
], ids=["minicpm-weights", "qwen3moe-kv", "qwen3moe-dispatch"])
def test_dry_run_int8_variants_are_ok(monkeypatch, arch, variant):
    """Each int8 variant traces on rank 0's shards of the 16-wide model
    group.  int8 weights: fewer parameter bytes a rank than bf16, in the
    reference layout and the port's, the load-time absmax reduce made
    (before the step) and the step's collectives the bf16 step's.  The
    int8 ring holds fewer cache bytes; int8 dispatch gathers fewer
    bytes in as many calls."""
    maxes = []
    inner = ctx.max_model
    monkeypatch.setattr(ctx, "max_model",
                        lambda x: maxes.append(x.shape) or inner(x))
    rec = D.run_cell(arch, "decode_32k", False, verbose=False,
                     variant=variant)
    base = _bf16_cell(arch)
    assert rec["status"] == "ok", rec.get("error") or rec.get("reason")
    assert base["status"] == "ok"
    assert rec["collective_counts"] == base["collective_counts"]
    layout, base_layout = rec["port_layout"], base["port_layout"]
    if "weight_dtype" in variant:
        assert maxes, "no absmax was reduced over the model axis"
        assert rec["params_local_bytes"] < base["params_local_bytes"]
        assert layout["params_local_bytes"] < base_layout["params_local_bytes"]
        assert rec["collective_bytes_by_op"] == base["collective_bytes_by_op"]
    else:
        assert not maxes
        assert layout["params_local_bytes"] == \
            base_layout["params_local_bytes"]
    if "kv_dtype" in variant:
        assert layout["inputs_local_bytes"] < base_layout["inputs_local_bytes"]
    if "dispatch_dtype" in variant:
        got = rec["collective_bytes_by_op"]["all-gather"]
        assert got < base["collective_bytes_by_op"]["all-gather"]
