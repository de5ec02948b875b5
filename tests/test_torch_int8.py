"""int8 serving in the port against the JAX package: weights, the KV ring
and MoE dispatch (analogues of tests/test_quantization.py:27-91).

- ``quantize_params`` gives the reference's codes and scales bit for bit
  (llama, phi4-mini, reduced qwen3-moe's router and experts, mamba2's
  ``in_proj``, ``out_proj`` and ``conv_w``), block by block; the bridge
  carries a quantized tree across with int8 codes and float32 scales
  whatever ``dtype`` asks.
- ``quantize_kv`` / ``dequantize_kv``: bitwise on the same inputs.
- The int8 ring: prefill (identity layout and a ring shorter than the
  prompt), then 4 decode steps, against the JAX model's int8 ring.  The
  logits hold at the reference test's relative bound (5e-3).  The ring's
  codes may differ by one where the two frameworks' float32 K/V differ
  by an ulp across a rounding boundary: at most 1, in under 1% of
  entries; positions exactly, scales at 2e-5.
- int8 weights: forward, prefill + decode and the paged prefill, decode
  and verify, at 2e-5 against the JAX model on the same quantized tree.
- int8 MoE dispatch: the layer against JAX's at 2e-5 with ``load`` and
  ``dropped`` exact, repeating bitwise; the reduced qwen3-moe's forward.
- The reduced llama with int8 weights and KV served by the torch
  ``RealBackend`` and by the JAX one: a bit-exact control plane and the
  near-argmax replay within 0.05; the emulated step graphs of an int8
  dense serve equal its eager serve.
- int8 on a mesh wider than 1 raises, naming ROADMAP item 8.
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
import repro_torch.serving as TS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import layers as JL
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro.serving.realengine import make_real_backend_factory
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.power import A100 as TA100
from repro_torch.distributed.context import mesh_context
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import jitcache
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import (
    make_real_backend_factory as t_factory,
)
import _arch_parity as AP
from _port_parity import assert_same_run, replay_near_argmax
from test_torch_graphs import counting, emulated_capture  # noqa: F401

MAX_LEN = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(j, t, path=""):
    """Pairs of (path, JAX numpy leaf, port tensor) over the same tree."""
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            yield from _walk(j[k], t[k], f"{path}/{k}")
    else:
        yield path, j, t


def _pair(arch, dtype="float32", **moe):
    """The reduced config on both sides and the same float weights (every
    norm off its zero init)."""
    rc, trc = AP.configs(arch, dtype, **moe)
    params, tparams = AP.pair(rc, trc)
    return rc, trc, params, tparams


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama-3.1-8b", "phi4-mini-3.8b",
                                  "qwen3-moe-30b-a3b", "mamba2-2.7b"])
def test_quantize_params_equals_the_reference_bitwise(arch):
    rc, trc, params, tparams = _pair(arch)
    qj, qt = _np(M.quantize_params(params)), TM.quantize_params(tparams)
    assert TM.params_quantized(qt) and not TM.params_quantized(tparams)
    names = set()
    for path, j, t in _walk(qj, qt):
        assert str(t.dtype) == f"torch.{j.dtype}", path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
        if path.endswith("/q8"):
            names.add(path.split("/")[-2])
    want = {"wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out"}
    if arch == "mamba2-2.7b":
        want = {"in_proj", "out_proj", "conv_w"}
    elif arch == "qwen3-moe-30b-a3b":
        want = want | {"router"}
    assert names == want
    # the float tree is left as it was
    for path, j, t in _walk(_np(params), tparams):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


def test_bridge_keeps_codes_int8_and_scales_float32():
    rc, _, params, _ = _pair("llama-3.1-8b")
    tq = params_from_jax(_np(M.quantize_params(params)), device="cpu",
                         dtype=torch.bfloat16)
    wq = tq["blocks"]["layer_0"]["attn"]["wq"]
    assert wq["q8"].dtype == torch.int8
    assert wq["sc"].dtype == torch.float32
    assert tq["blocks"]["layer_0"]["attn"]["norm"].dtype == torch.bfloat16
    assert tq["embed"].dtype == torch.bfloat16


def _quantized(arch, dtype="float32"):
    rc, trc, params, _ = _pair(arch, dtype)
    rc8, trc8 = (dataclasses.replace(c, weight_dtype="int8")
                 for c in (rc, trc))
    qp = M.quantize_params(params)
    return rc8, trc8, qp, params_from_jax(_np(qp), device="cpu")


def test_int8_weights_forward_prefill_and_decode_match():
    rc, trc, qp, tqp = _quantized("llama-3.1-8b")
    assert TM.init_params(trc, torch.Generator().manual_seed(0),
                          device="cpu")["blocks"]["layer_0"]["attn"][
        "wq"].dtype == torch.float32  # init gives the float tree
    rng = np.random.default_rng(4)
    toks = rng.integers(0, rc.vocab_size, (2, 32)).astype(np.int32)
    AP.check_forward(rc, trc, qp, tqp, toks)
    AP.check_prefill_decode(rc, trc, qp, tqp, toks,
                            np.array([21, 32], np.int32), MAX_LEN, steps=4)


def test_int8_weights_paged_prefill_decode_verify_match():
    AP.check_paged(*_quantized("llama-3.1-8b"))


def test_int8_weights_mamba2_forward_and_decode_match():
    rc, trc, qp, tqp = _quantized("mamba2-2.7b")
    toks = np.random.default_rng(5).integers(
        0, rc.vocab_size, (2, 64)).astype(np.int32)
    AP.check_forward(rc, trc, qp, tqp, toks)
    AP.check_prefill_decode(rc, trc, qp, tqp, toks,
                            np.array([64, 40], np.int32), MAX_LEN, steps=4)


# ---------------------------------------------------------------------------
# The KV ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_round_trip_equals_the_reference_bitwise(dtype):
    x = np.random.default_rng(6).normal(size=(4, 16, 8, 32)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, scj = M.quantize_kv(xj)
    qt, sct = TM.quantize_kv(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sct.numpy(), np.asarray(scj))
    back_j = M.dequantize_kv(qj, scj, xj.dtype)
    back_t = TM.dequantize_kv(qt, sct, xt.dtype)
    np.testing.assert_array_equal(back_t.float().numpy(),
                                  np.asarray(back_j, np.float32))


def _ring_close(cj, ct, what):
    """An int8 ring against the reference's: positions exact, scales at
    2e-5, codes at most one apart in under 1% of the entries."""
    for name, ej in cj.items():
        et = ct[name]
        np.testing.assert_array_equal(et["pos"].numpy(),
                                      np.asarray(ej["pos"]))
        for key in ("k", "v"):
            assert et[key].dtype == torch.int8
            diff = np.abs(et[key].numpy().astype(np.int32)
                          - np.asarray(ej[key], np.int32))
            assert diff.max() <= 1, f"{what} {name}.{key}"
            assert (diff > 0).mean() < 0.01, f"{what} {name}.{key}"
            AP.close(ej[f"{key}_sc"], et[f"{key}_sc"],
                     what=f"{what} {name}.{key}_sc")


@pytest.mark.parametrize("max_len", [28, 16], ids=["ring", "short-ring"])
def test_int8_kv_decode_matches(max_len):
    """tests/test_quantization.py:27's case (phi4-mini, prompts of 24,
    4 decode steps) on both sides; with max_len 16 the ring is shorter
    than the prompt and keeps its last 16 positions."""
    rc, trc, params, tparams = _pair("phi4-mini-3.8b")
    rc8, trc8 = (dataclasses.replace(c, kv_dtype="int8") for c in (rc, trc))
    toks = np.random.default_rng(7).integers(
        0, rc.vocab_size, (2, 28)).astype(np.int32)
    lengths = np.array([24, 19], np.int32)
    lj, cj = M.prefill(params, rc8, jnp.asarray(toks[:, :24]),
                       jnp.asarray(lengths), max_len=max_len)
    lt, ct = TM.prefill(tparams, trc8, torch.from_numpy(toks[:, :24]),
                        torch.from_numpy(lengths), max_len=max_len)
    assert set(ct["layer_0"]) == {"k", "v", "pos", "k_sc", "v_sc"}

    def rel(j, t):
        j = np.asarray(j, np.float64)
        return np.abs(t.double().numpy() - j).max() / np.abs(j).max()

    assert rel(lj, lt) < 5e-3
    _ring_close(cj, ct, "prefill ring")
    decode = jax.jit(partial(M.decode_step, cfg=rc8))
    pos = lengths.copy()
    for t in range(4):
        tok = toks[:, 24 + t]
        lj, cj = decode(params, tokens=jnp.asarray(tok), cache=cj,
                        lengths=jnp.asarray(pos))
        lt, ct = TM.decode_step(tparams, trc8, torch.from_numpy(tok), ct,
                                torch.from_numpy(pos))
        assert rel(lj, lt) < 5e-3, f"decode step {t}"
        pos = pos + 1
    _ring_close(cj, ct, "ring after 4 steps")


def test_paged_pool_refuses_int8_kv_as_the_reference_does():
    rc, trc = (dataclasses.replace(c, kv_dtype="int8") for c in
               AP.configs("llama-3.1-8b"))
    with pytest.raises(ValueError, match="int8 KV") as want:
        M.init_paged_cache(rc, 8, 8)
    with pytest.raises(ValueError, match="int8 KV") as got:
        TM.init_paged_cache(trc, 8, 8, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k,cf", [(96, 8, 2, 4.0), (64, 8, 2, 1.0),
                                      (8, 128, 8, 1.25)],
                         ids=["T96-E8-cf4", "T64-E8-cf1-drops",
                              "T8-E128-k8-C1"])
def test_int8_moe_dispatch_matches(T, E, k, cf):
    rng = np.random.default_rng(8)
    d, ffe = 32, 16
    arrays = [rng.normal(size=(T, d)).astype(np.float32),
              (rng.normal(size=(d, E)) * 0.5).astype(np.float32)] + [
        (rng.normal(size=s) * 0.1).astype(np.float32)
        for s in ((E, d, ffe), (E, d, ffe), (E, ffe, d))]
    kw = dict(top_k=k, capacity_factor=cf, dispatch_dtype="int8")
    yj, aj = jax.jit(partial(JL.moe_ffn_sorted, **kw))(
        *[jnp.asarray(a) for a in arrays])
    tx = [torch.from_numpy(a) for a in arrays]
    yt, at = TL.moe_ffn_sorted(*tx, **kw)
    AP.close(yj, yt, what="int8 dispatch out")
    np.testing.assert_array_equal(at["load"].numpy(), np.asarray(aj["load"]))
    assert int(at["dropped"]) == int(aj["dropped"])
    y2, a2 = TL.moe_ffn_sorted(*tx, **kw)
    assert torch.equal(yt, y2) and torch.equal(at["load"], a2["load"])
    # and it is a quantized dispatch: not the float one's output
    yf, _ = TL.moe_ffn_sorted(*tx, top_k=k, capacity_factor=cf)
    assert not torch.equal(yt, yf)


def test_int8_dispatch_qwen3_moe_forward_matches():
    """The reduced qwen3-moe with int8 dispatch.  Through the model the
    two frameworks' float32 rows differ by ulps, and a row element that
    sits on a rounding boundary of its code takes the next code: one
    quantization step (max|row| / 127) in that element.  So, as for the
    int8 ring: the reference test's relative bound (5e-3) on the hidden
    states and logits, and 2e-5 in all but under 1% of the elements."""
    rc, trc, params, tparams = _pair("qwen3-moe-30b-a3b",
                                     dispatch_dtype="int8")
    toks = np.random.default_rng(9).integers(
        0, rc.vocab_size, (2, 32)).astype(np.int32)
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
    for what, j, t in (("hidden", hj, ht),
                       ("logits", M.lm_logits(params, rc, hj),
                        TM.lm_logits(tparams, trc, ht))):
        j = np.asarray(j, np.float64)
        err = np.abs(t.double().numpy() - j)
        assert err.max() / np.abs(j).max() < 5e-3, what
        assert (err > 2e-5 + 2e-5 * np.abs(j)).mean() < 0.01, what


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _workload(pkg, vocab, seed=21, duration=3.0):
    tiny = pkg.DatasetDist("tiny", prefill=pkg.LengthDist(24.0, 10.0, hi=60),
                           decode=pkg.LengthDist(6.0, 3.0, hi=12))
    reqs = pkg.poisson_workload(tiny, 2.5, duration, seed=seed)
    return pkg.attach_tokens(reqs, vocab, seed=seed + 1)


@pytest.fixture(scope="module")
def int8_llama():
    """The reduced llama with int8 weights and an int8 ring, quantized by
    the JAX package and carried across."""
    rc, trc, qp, tqp = _quantized("llama-3.1-8b")
    rc, trc = (dataclasses.replace(c, kv_dtype="int8") for c in (rc, trc))
    return SimpleNamespace(rc=rc, trc=trc, qp=qp, tqp=tqp)


def _cluster(pkg, cfg, factory, pred, reqs):
    return pkg.PDCluster(pkg.ClusterConfig(
        model=cfg, chip=A100 if pkg is JS else TA100, n_prefill=1,
        n_decode=2, policy="voltana", predictor=pred,
        kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=4, noise_sigma=0.0,
        prefill_chunk_tokens=32, backend_factory=factory)).run(reqs)


def test_int8_cluster_matches_jax_cluster(int8_llama):
    s = int8_llama
    arch = "llama-3.1-8b"
    runs = []
    for pkg, cfg, factory, pred in (
            (JS, REGISTRY[arch],
             make_real_backend_factory(s.rc, s.qp, slots=8, max_len=MAX_LEN),
             build_predictor(REGISTRY[arch], A100, A100.freq_levels_2,
                             kv_cap=400_000)),
            (TS, TREG[arch],
             t_factory(s.trc, s.tqp, slots=8, max_len=MAX_LEN, device="cpu"),
             t_build_predictor(TREG[arch], TA100, TA100.freq_levels_2,
                               kv_cap=400_000))):
        reqs = _workload(pkg, s.rc.vocab_size)
        m = _cluster(pkg, cfg, factory, pred, reqs)
        assert m.finished_frac() == 1.0
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    assert_same_run(ra, ma, rb, mb)
    replay_near_argmax(s.rc, s.qp, rb, MAX_LEN)


def test_emulated_graphs_of_an_int8_serve_equal_eager(int8_llama, counting,
                                                      monkeypatch):
    s = int8_llama
    pred = t_build_predictor(TREG["llama-3.1-8b"], TA100,
                             TA100.freq_levels_2, kv_cap=400_000)

    def serve():
        factory = t_factory(s.trc, s.tqp, slots=8, max_len=MAX_LEN,
                            device="cpu")
        reqs = _workload(TS, s.rc.vocab_size)
        graphs0 = (jitcache.capture_count(), jitcache.replay_count())
        m = _cluster(TS, TREG["llama-3.1-8b"], factory, pred, reqs)
        assert m.finished_frac() == 1.0
        return ([list(r.output_tokens) for r in reqs],
                jitcache.capture_count() - graphs0[0],
                jitcache.replay_count() - graphs0[1])

    jitcache.clear()
    eager, c0, r0 = serve()
    assert c0 == r0 == 0
    jitcache.clear()
    monkeypatch.setattr(jitcache, "graphs_available", lambda device: True)
    monkeypatch.setattr(jitcache, "_capture", emulated_capture)
    graphs, captures, replays = serve()
    assert graphs == eager
    assert captures > 0 and replays > 0


def test_int8_on_a_wide_mesh_raises_item_8():
    """Every int8 mode on a width-2 mesh: the model's check and the
    serving factory, before any process group."""
    wide = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    llama = TREG["llama-3.1-8b"].reduced()
    moe = TREG["qwen3-moe-30b-a3b"].reduced()
    for cfg in (dataclasses.replace(llama, weight_dtype="int8"),
                dataclasses.replace(llama, kv_dtype="int8"),
                dataclasses.replace(moe, moe=dataclasses.replace(
                    moe.moe, dispatch_dtype="int8"))):
        TM.check_supported(cfg)  # off the mesh: served
        with mesh_context(wide):
            with pytest.raises(NotImplementedError, match="item 8"):
                TM.check_supported(cfg)
        with pytest.raises(NotImplementedError, match="item 8"):
            t_factory(cfg, {}, device="cpu", tp=2, devices=[0, 1])
