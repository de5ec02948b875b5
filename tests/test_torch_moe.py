"""Mixture-of-experts in the port against the JAX package.

The layer functions (``moe_ffn_sorted``, ``moe_ffn``) at several token
counts, expert counts, top-k and capacity factors: routing (each token's
experts and each entry's kept slot), ``load`` and ``dropped`` exactly
equal to the JAX layer's, ``out`` and ``me`` at the float32 tolerance,
on batches with drops, with pad rows (one row repeated) and with zero
rows (every probability tied, so ``lax.top_k``'s lower-index rule picks
the experts).  The reduced qwen3-moe (also at capacity factor 1.0, so
that entries drop) and dbrx through ``_arch_parity``'s model checks, the
served clusters against the JAX package's, and the step graphs (CPU
emulation of ``tests/test_torch_graphs.py``) of a MoE decode, paged and
speculative serve against eager steps.
"""
import math
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.serving as JS
import repro_torch.serving as TS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import layers as JL
from repro.serving.cluster import build_predictor
from repro.serving.realengine import make_real_backend_factory
from repro_torch import kernels
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.power import A100 as TA100
from repro_torch.models import layers as TL
from repro_torch.serving import jitcache
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import (
    make_draft_config,
    make_real_backend_factory as t_factory,
)
import _arch_parity as AP
from _port_parity import assert_same_run, replay_near_argmax
from test_torch_graphs import counting, emulated_capture  # noqa: F401

MAX_LEN = 128

# (T, E, k, capacity factor, batch): test_models.py:263's shape, drops at
# capacity factor 1.0 and at qwen3-moe's decode capacity (8 rows over
# 128 experts, C = 1), pad rows, and zero rows
LAYER_CASES = [
    pytest.param(96, 8, 2, 8.0, "random", id="T96-E8-k2-cf8"),
    pytest.param(64, 8, 2, 1.0, "random", id="T64-E8-k2-cf1-drops"),
    pytest.param(64, 4, 2, 1.25, "pad", id="T64-E4-k2-cf1.25-pad"),
    pytest.param(16, 16, 4, 1.25, "zero", id="T16-E16-k4-cf1.25-zero"),
    pytest.param(8, 128, 8, 1.25, "random", id="T8-E128-k8-cf1.25-C1"),
]


def _layer_inputs(T, E, k, batch, seed=0, d=32, ffe=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    if batch == "pad":  # the last half: one pad token's row, repeated
        x[T // 2:] = x[T // 2]
    elif batch == "zero":  # empty rows: every router probability equal
        x[::3] = 0.0
    router = (rng.normal(size=(d, E)) * 0.5).astype(np.float32)
    w = [(rng.normal(size=s) * 0.1).astype(np.float32)
         for s in ((E, d, ffe), (E, d, ffe), (E, ffe, d))]
    return [x, router] + w


def _jax_routing(x, router, k, cf):
    """The JAX layer's routing (repro/models/layers.py:393-409), step
    for step: each token's experts and each token-major entry's slot
    (E·C where dropped)."""
    T, E = x.shape[0], router.shape[-1]
    C = max(1, int(math.ceil(T * k / E * cf)))
    logits = jnp.einsum("td,de->te", x, router,
                        preferred_element_type=jnp.float32)
    _, tope = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = tope.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    rank = jnp.arange(se.shape[0]) - jnp.searchsorted(se, se, side="left")
    slot_sorted = jnp.where(rank < C, se * C + rank, E * C)
    slot = jnp.zeros_like(slot_sorted).at[order].set(slot_sorted)
    return np.asarray(tope), np.asarray(slot)


@pytest.mark.parametrize("T,E,k,cf,batch", LAYER_CASES)
def test_moe_layers_match_jax(T, E, k, cf, batch):
    arrays = _layer_inputs(T, E, k, batch)
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    outs = []
    for jfn, tfn in ((JL.moe_ffn_sorted, TL.moe_ffn_sorted),
                     (JL.moe_ffn, TL.moe_ffn)):
        yj, aj = jax.jit(partial(jfn, top_k=k, capacity_factor=cf))(*jx)
        yt, at = tfn(*tx, top_k=k, capacity_factor=cf)
        AP.close(yj, yt, what=f"{tfn.__name__} out")
        AP.close(aj["me"], at["me"], what=f"{tfn.__name__} me")
        np.testing.assert_array_equal(at["load"].numpy(),
                                      np.asarray(aj["load"]))
        assert int(at["dropped"]) == int(aj["dropped"])
        outs.append((yt, at))
    # sorted dispatch equals the one-hot one (tests/test_models.py:263),
    # here bit for bit: the same slots, buffers and combine
    (ys, as_), (yo, ao) = outs
    assert torch.equal(ys, yo)
    for key in ("load", "dropped", "me"):
        assert torch.equal(as_[key], ao[key])
    # the routing itself: experts per token and the kept slot per entry
    tope_j, slot_j = _jax_routing(*jx[:2], k, cf)
    _, _, tope_t, C = TL._route(tx[0], tx[1], k, cf)
    order, slot_sorted = TL._sorted_slots(tope_t.reshape(-1), E, C)
    slot_t = torch.empty_like(slot_sorted)
    slot_t[order] = slot_sorted
    np.testing.assert_array_equal(tope_t.numpy(), tope_j)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    if cf <= 1.0 or E == 128:
        assert int(as_["dropped"]) > 0, "the case was meant to drop"
    if batch == "zero":  # tied rows take the lowest expert indices
        assert tope_t[0].tolist() == list(range(k))


def test_int8_dispatch_raises():
    """int8 dispatch is served off a mesh and on a mesh wider than 1
    alike: the layer runs it (its parity with the JAX layer is in
    tests/test_torch_int8.py, on a slice in tests/test_torch_mesh_int8.py)
    and the model's check refuses it nowhere."""
    import dataclasses

    from repro_torch.distributed.context import mesh_context
    from repro_torch.models import model as TM

    arrays = [torch.from_numpy(a) for a in _layer_inputs(8, 4, 2, "random")]
    out, aux = TL.moe_ffn_sorted(*arrays, top_k=2, dispatch_dtype="int8")
    assert torch.isfinite(out).all() and int(aux["load"].sum()) == 16
    moe = TREG["qwen3-moe-30b-a3b"].reduced()
    int8 = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, dispatch_dtype="int8"))
    TM.check_supported(int8)
    wide = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    with mesh_context(wide):
        TM.check_supported(int8)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

ARCHS = [
    pytest.param(("qwen3-moe-30b-a3b", {}), id="qwen3-moe"),
    pytest.param(("qwen3-moe-30b-a3b", dict(capacity_factor=1.0)),
                 id="qwen3-moe-cf1"),
    pytest.param(("dbrx-132b", {}), id="dbrx"),
]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch, kw = request.param
    rc, trc = AP.configs(arch, **kw)
    params, tparams = AP.pair(rc, trc)
    return rc, trc, params, tparams


def _dropped(monkeypatch):
    """The port's MoE layers' dropped entries, summed over calls."""
    seen = []
    inner = TL.moe_ffn_sorted

    def spy(*a, **kw):
        out, aux = inner(*a, **kw)
        seen.append(int(aux["dropped"]))
        return out, aux

    monkeypatch.setattr(TL, "moe_ffn_sorted", spy)
    return seen


def test_forward_with_aux_loss_matches(case, monkeypatch):
    rc, trc, params, tparams = case
    dropped = _dropped(monkeypatch)
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 64))
    aux = AP.check_forward(rc, trc, params, tparams, toks.astype(np.int32))
    assert aux > 0.5  # E * sum(f * me): about 1 when balanced
    assert len(dropped) == rc.n_layers
    if rc.moe.capacity_factor <= 1.0:
        assert sum(dropped) > 0, "capacity factor 1.0 should drop entries"


def test_prefill_with_a_short_ring_then_decode_matches(case):
    rc, trc, params, tparams = case
    toks = np.random.default_rng(2).integers(
        0, rc.vocab_size, (2, 64)).astype(np.int32)
    AP.check_prefill_decode(rc, trc, params, tparams, toks,
                            np.array([40, 64], np.int32), max_len=32)


def test_paged_prefill_decode_verify_match(case):
    AP.check_paged(*case)


def test_forward_matches_in_bfloat16():
    rc, trc = AP.configs("qwen3-moe-30b-a3b", "bfloat16")
    params, tparams = AP.pair(rc, trc)
    toks = np.random.default_rng(3).integers(0, rc.vocab_size, (2, 40))
    AP.check_forward(rc, trc, params, tparams, toks.astype(np.int32),
                     "bfloat16")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _workload(pkg, vocab, seed=21, duration=10.0):
    tiny = pkg.DatasetDist("tiny", prefill=pkg.LengthDist(24.0, 10.0, hi=60),
                           decode=pkg.LengthDist(6.0, 3.0, hi=12))
    reqs = pkg.poisson_workload(tiny, 2.5, duration, seed=seed)
    return pkg.attach_tokens(reqs, vocab, seed=seed + 1)


def test_moe_cluster_matches_jax_cluster():
    """The reduced qwen3-moe (capacity factor 4.0: no entry can drop, so
    a stream does not depend on its batch-mates and a request replays
    alone) served dense by the port and by the JAX package: the same
    run, and every token near the JAX model's argmax."""
    arch = "qwen3-moe-30b-a3b"
    rc, trc = AP.configs(arch)
    params, tparams = AP.pair(rc, trc)
    runs = []
    for pkg, cfg, factory, pred in (
            (JS, REGISTRY[arch],
             make_real_backend_factory(rc, params, slots=8, max_len=MAX_LEN),
             build_predictor(REGISTRY[arch], A100, A100.freq_levels_2,
                             kv_cap=400_000)),
            (TS, TREG[arch],
             t_factory(trc, tparams, slots=8, max_len=MAX_LEN, device="cpu"),
             t_build_predictor(TREG[arch], TA100, TA100.freq_levels_2,
                               kv_cap=400_000))):
        reqs = _workload(pkg, rc.vocab_size, duration=4.0)
        m = pkg.PDCluster(pkg.ClusterConfig(
            model=cfg, chip=A100 if pkg is JS else TA100, n_prefill=1,
            n_decode=2, policy="voltana", predictor=pred,
            kv_capacity_tokens=400_000, online_adapt=False,
            decode_max_running=8, seed=4, noise_sigma=0.0,
            prefill_chunk_tokens=32, backend_factory=factory)).run(reqs)
        assert m.finished_frac() == 1.0
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    assert_same_run(ra, ma, rb, mb)
    replay_near_argmax(rc, params, rb, MAX_LEN)


# step graphs: (backend keywords, cluster keywords, step entries a
# decode backend uses)
GRAPH_CASES = {
    "dense": ({}, {}, 1),
    "paged": (dict(paged=True, page_size=16),
              dict(paged=True, kv_page_size=16), 1),
    "spec": (dict(paged=True, page_size=16, spec_k=2),
             dict(paged=True, kv_page_size=16, spec_decode=True, spec_k=2),
             2),
}


@pytest.fixture(scope="module")
def moe_side():
    """The reduced qwen3-moe at capacity factor 1.0 (entries drop at
    decode: 8 rows x 2 over 4 experts leave 4 slots each) and its
    drafter, a MoE too."""
    _, trc = AP.configs("qwen3-moe-30b-a3b", capacity_factor=1.0)
    from repro_torch.models import model as TM

    params = TM.init_params(trc, torch.Generator().manual_seed(0),
                            device="cpu")
    dcfg = make_draft_config(trc)
    dparams = TM.init_params(dcfg, torch.Generator().manual_seed(1),
                             device="cpu")
    llama = TREG["llama-3.1-8b"]
    pred = t_build_predictor(llama, TA100, TA100.freq_levels_2,
                             kv_cap=400_000, spec_k=2)
    return SimpleNamespace(cfg=trc, params=params, dcfg=dcfg,
                           dparams=dparams, model=llama, pred=pred)


def _serve(side, case, dropped):
    bkw, ckw, _ = GRAPH_CASES[case]
    if bkw.get("spec_k"):
        bkw = dict(bkw, draft_cfg=side.dcfg, draft_params=side.dparams)
    factory = t_factory(side.cfg, side.params, slots=8, max_len=MAX_LEN,
                        device="cpu", **bkw)
    reqs = _workload(TS, side.cfg.vocab_size)
    cl = TS.PDCluster(TS.ClusterConfig(
        model=side.model, chip=TA100, n_prefill=1, n_decode=2,
        policy="voltana", predictor=side.pred, kv_capacity_tokens=400_000,
        online_adapt=False, decode_max_running=8, seed=4, noise_sigma=0.0,
        prefill_chunk_tokens=32, backend_factory=factory, **ckw))
    launches0 = kernels.launch_counts()
    graphs0 = (jitcache.capture_count(), jitcache.replay_count())
    n0 = len(dropped)
    m = cl.run(reqs)
    assert m.finished_frac() == 1.0
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1
    return SimpleNamespace(
        cluster=cl, streams=[list(r.output_tokens) for r in reqs],
        launches=kernels.launches_since(launches0),
        dropped=sum(dropped[n0:]),
        captures=jitcache.capture_count() - graphs0[0],
        replays=jitcache.replay_count() - graphs0[1])


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_emulated_graphs_serve_what_eager_serves(moe_side, counting,
                                                 monkeypatch, case):
    """A MoE serve through emulated step graphs emits the eager serve's
    streams bit for bit, with the same launch counts, one capture per
    decode backend and entry, and every later step a replay; entries
    drop on the way, so each row's output depends on its batch."""
    dropped = _dropped(monkeypatch)
    jitcache.clear()
    eager = _serve(moe_side, case, dropped)
    assert eager.captures == eager.replays == 0
    assert eager.launches, "the counting wrappers never ran"
    assert eager.dropped > 0
    jitcache.clear()
    monkeypatch.setattr(jitcache, "graphs_available", lambda device: True)
    monkeypatch.setattr(jitcache, "_capture", emulated_capture)
    graphs = _serve(moe_side, case, dropped)
    assert graphs.streams == eager.streams
    assert graphs.launches == eager.launches
    entries = GRAPH_CASES[case][2]
    steps = stepped = 0
    for e in graphs.cluster.decode:
        n = e.backend.pipeline_dispatches
        stepped += n > 0
        steps += n * (4 if case == "spec" else 1)
    assert graphs.captures == entries * stepped > 0
    assert graphs.replays == steps - graphs.captures > 0
