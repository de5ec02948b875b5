"""MoE experts over ``"model"`` in the port against the JAX package
(the JAX layer's ``expert_sharding``, ``repro/models/layers.py:376,
430-452``, placed by ``expert_pspec`` at ``repro/models/model.py:
396-403``), with the hybrid jamba (SSD heads and experts both split).

On a slice the tokens are replicated: every rank routes all of them
with the whole router (C from the global E, so the drops are the full
routing's), fills and runs only its own experts' slab of the dispatch
buffer, and gathers every expert's output over ``"model"`` before the
meshless combine.  The worlds are spawned gloo worlds on the CPU
(``_mesh_worlds.py``, no JAX in the ranks), on the reduced configs in
float32:

* dense and paged/verify logits of qwen3-moe at tp 2 and 4 against the
  meshless JAX model at ``TOL`` (tests/test_mesh_parity.py:224,345):
  4 experts split at both widths (at tp 4 the 2 kv heads stay whole), 6
  experts split at tp 2 and stay whole at tp 4 (the replicated
  fallback), and capacity factor 1, where entries drop;
* jamba's dense logits at tp 2 and 4 (Mamba2 heads, attention heads and
  experts on one slice);
* the JAX package's acceptance scenario (tests/test_mesh_parity.py:
  400-436): a tp=2 qwen3-moe paged cluster against the JAX meshless
  cluster at the same ``ClusterConfig(tp=2)``: bit-equal control plane
  and stream lengths, the same streams on both ranks, each token within
  0.05 of the JAX max logit, every decode instance on a 2-wide axis with
  a drained pool;
* with no world: the layer's shards joined by their gather equal the
  meshless layer bitwise (output and aux), and the cut of the JAX tree
  at widths 2 and 4 joins back leaf for leaf.
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
from repro_torch.distributed import sharding as SH
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
MOE = "qwen3-moe-30b-a3b"
JAMBA = "jamba-v0.1-52b"
MOE_MODEL = REGISTRY[MOE]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(reg):
    """{variant: config}: qwen3-moe as reduced (4 experts), with 6
    experts, and at capacity factor 1; jamba reduced."""
    rc = dataclasses.replace(reg[MOE].reduced(), dtype="float32")
    return {
        "moe": rc,
        "moe6": dataclasses.replace(rc, moe=dataclasses.replace(
            rc.moe, num_experts=6)),
        "moe-cf1": dataclasses.replace(rc, moe=dataclasses.replace(
            rc.moe, capacity_factor=1.0)),
        "jamba": dataclasses.replace(reg[JAMBA].reduced(), dtype="float32"),
    }


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    cfgs, tcfgs = _configs(REGISTRY), _configs(TREG)
    params = {name: _np(M.init_params(cfgs[name], jax.random.key(1)))
              for name in ("moe", "moe6", "jamba")}
    params["moe-cf1"] = params["moe"]  # the capacity is not a weight
    params["jamba"] = live_state(params["jamba"], cfgs["jamba"])
    # paged/verify steps for qwen3-moe itself; dense steps elsewhere
    scripts = {name: forward_script(rc, paged=name == "moe")
               for name, rc in cfgs.items()}
    variants = [(name, tcfgs[name], params[name], scripts[name])
                for name in cfgs]
    pred = t_build_predictor(TREG[MOE], TA100, TA100.freq_levels_2,
                             kv_cap=400_000)
    worlds = {tp: W.start_world(W.forward_rank, tp, tmp, variants)
              for tp in TPS}
    worlds["cluster"] = W.start_world(
        W.mixer_cluster_rank, 2, tmp,
        [("moe", MOE, tcfgs["moe"], params["moe"], "acceptance")],
        {"moe": pred})
    want = {}

    def jax_logits(name):
        if name not in want:
            want[name] = jax_forward(M, cfgs[name], params[name],
                                     scripts[name])
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
@pytest.mark.parametrize("name", ["moe", "moe6", "moe-cf1", "jamba"])
def test_forward_parity(ref, tp, name):
    """Every rank's logits within ``TOL`` of the meshless JAX model:
    dense prefill and decode (for qwen3-moe itself also paged prefill,
    decode and a verify window)."""
    want = ref.jax_logits(name)
    ranks = ref.worlds[tp].result()
    assert len(ranks) == tp
    for rank, res in enumerate(ranks):
        assert len(res[name]) == len(want)
        for step, (got, w) in enumerate(zip(res[name], want)):
            np.testing.assert_allclose(got, w, **TOL,
                                       err_msg=f"rank {rank} step {step}")


# ---------------------------------------------------------------------------
# The JAX package's acceptance scenario
# ---------------------------------------------------------------------------


def test_sharded_moe_cluster_end_to_end(ref):
    """tests/test_mesh_parity.py:400-436 in the port: a tp=2 qwen3-moe
    cluster over the paged pool, held against the JAX meshless cluster
    at the same config."""
    rc, params = ref.cfgs["moe"], ref.params["moe"]
    pred = build_predictor(MOE_MODEL, A100, A100.freq_levels_2,
                           kv_cap=400_000)
    reqs = W.acceptance_workload(JS, rc.vocab_size)
    ma = JS.PDCluster(W.acceptance_cfg(
        JS, MOE_MODEL, A100, pred,
        backend_factory=make_real_backend_factory(
            rc, params, slots=8, max_len=W.MAX_LEN, paged=True,
            page_size=16))).run(reqs)
    ranks = ref.worlds["cluster"].result()
    (rb, mb, widths), (rc_, *_) = ranks[0]["moe"], ranks[1]["moe"]
    assert ma.finished_frac() == mb.finished_frac() == 1.0
    assert widths == [2]  # the ranks drained their pools, or failed
    assert_same_run(reqs, ma, rb, mb)
    for a, b in zip(rb, rc_):
        assert a.output_tokens == b.output_tokens, f"ranks differ, {a.rid}"
        assert len(a.output_tokens) == a.decode_len + 1
    replay_near_argmax(rc, params, rb, W.MAX_LEN)


# ---------------------------------------------------------------------------
# The layer and the cuts, no world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_expert_shards_gathered_equal_the_meshless_layer(n, cf):
    """``moe_ffn_sorted`` on each of ``n`` ranks' experts, the ranks'
    slabs joined as the gather joins them, gives the meshless layer's
    output and aux bitwise, drops (capacity factor 1) included."""
    rng = np.random.default_rng(5)
    T, d, E, ffe, k = 24, 32, 8, 16, 2
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(d, E)).astype(np.float32))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.2)
         for s in ((E, d, ffe), (E, d, ffe), (E, ffe, d))]
    kw = dict(top_k=k, capacity_factor=cf)
    want, aux = TL.moe_ffn_sorted(x, router, *w, **kw)
    assert cf > 1 or int(aux["dropped"]) > 0
    m = E // n
    slabs = [None] * n

    def run(i, gather):
        return TL.moe_ffn_sorted(
            x, router, *(t[i * m:(i + 1) * m] for t in w),
            expert_shard=TL.ExpertShard(first=i * m, gather=gather), **kw)

    for i in range(n):  # each rank's slab, as it would send it
        def keep(ye, i=i):
            slabs[i] = ye
            return torch.zeros((E * ye.shape[0] // m, d))
        run(i, keep)
    for i in range(n):
        got, got_aux = run(i, lambda ye: torch.cat(slabs))
        assert torch.equal(got, want), i
        for key in aux:
            assert torch.equal(got_aux[key], aux[key]), key


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", ["moe", "moe6", "jamba"])
def test_cut_jax_tree_joins_back(ref, tp, name):
    """The bridged JAX tree cut at width ``tp`` joins back leaf for leaf
    by each leaf's rule; the expert weights split on E where the experts
    divide the width, and the router stays whole."""
    rc = ref.tcfgs[name]
    full = params_from_jax(ref.params[name], device="cpu")
    cuts = [SH.shard_params(full, rc, W.FakeMesh(tp, i)) for i in range(tp)]
    split = W.assert_cuts_join(rc, full, cuts)
    experts = [p for p in split if "moe" in p and p[-1] != "router"]
    divides = rc.moe.num_experts % tp == 0
    assert len(experts) == (3 * sum(s.ffn == "moe" for s in rc.block_pattern)
                            if divides else 0)
    assert not any(p[-1] == "router" for p in split)
    moe = next(lp["moe"] for lp in cuts[0]["blocks"].values() if "moe" in lp)
    E = rc.moe.num_experts
    assert moe["w_gate"].shape[1] == (E // tp if divides else E)
