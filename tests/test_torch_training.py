"""The port's training path against the JAX package's, on the CPU.

- The attention gradient: the port's ``flash_attention`` under autograd
  (on the CPU, autograd through its plain version; on the card the
  ``flash_backward`` kernel, held in ``test_torch_cuda.py``) against
  ``jax.grad`` of the JAX ``attention_ref`` and of ``L.chunked_attention``.
- The train step on reduced minicpm-2b (the fixture of
  ``tests/test_training.py:29-34``: batch 4 x 64, ``ce_chunk`` 32) and a
  2-layer variant, reduced qwen3-moe (the aux loss) and reduced gemma2
  (window, attention and logit softcaps), JAX weights carried across with
  ``params_from_jax``; remat and microbatches.
- AdamW and the WSD schedule to 1 ulp (the global norm's reduction and
  ``cos`` aside, see their tests), int8 compression bit for bit, the
  checkpoint layout both ways, the refusals, and ``launch/train.py``.

Tolerances, all float32: 2e-5 relative to each gradient's max (the JAX
suite's float32 tolerance, ``tests/test_kernels.py:18``); 1e-5 relative
on a loss, 1e-4 over four steps.  After four AdamW steps a param may
differ by up to ``4 * lr * steps``: at step 1 ``mhat / sqrt(vhat)`` is
about +-1 wherever |g| is above eps, so a gradient near zero whose sign
differs between the frameworks moves that element by about 2 lr.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training as JT
from repro.configs.registry import REGISTRY as JREG
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models import layers as JL
from repro.models import model as JM
from repro.training.compress import compressed_wire_bytes as jax_wire
import repro_torch.training as TT
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.distributed import mesh_context
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.training import checkpoint as TC
from repro_torch.training import trainstep as TS
from repro_torch.training._tree import leaves, treedef_str
from repro_torch.training.compress import compressed_wire_bytes
import _arch_parity as AP

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 2e-5
LR = 1e-3
STEPS = 4


def _rel_close(want, got, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# The attention gradient
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (Hq, Hkv, Dh, causal, window, softcap)
    pytest.param(8, 2, 16, True, None, None, id="causal-G4-Dh16"),
    pytest.param(4, 4, 80, False, None, None, id="bidirectional-Dh80"),
    pytest.param(4, 2, 16, True, 16, 50.0, id="gemma2-window-softcap"),
]


@pytest.mark.parametrize("Hq,Hkv,Dh,causal,window,softcap", ATTN_CASES)
def test_attention_gradient_matches_jax(Hq, Hkv, Dh, causal, window,
                                        softcap):
    rng = np.random.default_rng(Dh + Hq)
    B, S = 2, 64
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh), (B, S, Hq, Dh)))
    kw = dict(causal=causal, window=window, softcap=softcap)

    def jax_grads(fn):
        def loss(q, k, v):
            return jnp.sum(fn(q, k, v) * g)
        return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                     (q, k, v)))

    ref = jax_grads(lambda q, k, v: jax_attention(q, k, v, **kw))
    chunked = jax_grads(lambda q, k, v: JL.chunked_attention(
        q, k, v, q_chunk=32, k_chunk=32, **kw))
    leaves_t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves_t, **kw)
    got = torch.autograd.grad(out, leaves_t, torch.from_numpy(g))
    for name, a, b, t in zip("qkv", ref, chunked, got):
        _rel_close(a, t, GRAD_TOL, f"d{name} vs attention_ref")
        _rel_close(b, t, GRAD_TOL, f"d{name} vs chunked_attention")
    # the wrapper's plain backward is the same gradient
    dq, dk, dv = fops.flash_backward(*(x.detach() for x in leaves_t),
                                     out.detach(), torch.from_numpy(g), None,
                                     **kw)
    for a, t in zip(got, (dq, dk, dv)):
        torch.testing.assert_close(a, t, atol=0, rtol=0)


def test_flash_backward_refuses_kv_len_and_q_start_and_other_devices():
    q = torch.zeros((1, 16, 4, 16))
    rows = torch.full((1,), 8, dtype=torch.int32)
    for name in ("kv_len", "q_start"):
        with pytest.raises(ValueError, match="kv_len or q_start"):
            fops.flash_backward(q, q, q, q, q, None, **{name: rows})
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no flash_backward"):
        fops.flash_backward(meta, meta, meta, meta, meta, None)


def test_backward_switch_names_the_flash_head_dims():
    """Every head dim the forward takes has a backward instantiation,
    and the backward is built with the other kernels."""
    text = (_build.CSRC / "flash_backward.cu").read_text()
    cases = tuple(int(n) for n in re.findall(
        r"case (\d+): err = launch<\1>", text))
    assert cases == _build.FLASH_HEAD_DIMS
    assert "flash_backward" in _build.KERNELS
    assert "atomicAdd" not in text  # a call repeats bitwise


@pytest.mark.parametrize("code,Dh,body", [
    (1, 64, "wgmma"), (1, 128, "wgmma"), (1, 16, "mma_sync"),
    (1, 80, "mma_sync"), (0, 64, "cuda_cores"), (0, 128, "cuda_cores"),
    (0, 16, "cuda_cores"), (0, 80, "cuda_cores"), (0, 32, "cuda_cores"),
])
def test_backward_body_by_dtype_and_head_dim(code, Dh, body):
    """bf16 at Dh 64 and 128 (every model the port trains at full width)
    goes to the one-pass wgmma body, bf16 at Dh 16 and 80 to the two-pass
    mma.sync body, float32 to the CUDA cores."""
    assert fops.backward_body(code, Dh) == body
    assert body in fops.BACKWARD_BODIES


@pytest.mark.parametrize("code,Dh", [(1, 96), (1, 256), (2, 64), (1, 32),
                                     (0, 48)])
def test_backward_body_refuses_what_no_body_takes(code, Dh):
    """Dh 32 has the float32 body only (the demo configs)."""
    with pytest.raises(ValueError, match="no flash_backward body"):
        fops.backward_body(code, Dh)


def test_backward_scratch_shapes_follow_the_body_and_the_tiles():
    """The wgmma body's scratch: lse/delta and dQ sums by 64-row query
    tile, a ticket and one turn per (b, q head, query tile), and with
    G > 1 the dK/dV sums and turns per (b, kv head, 128-key tile, half);
    the two-pass bodies take delta alone."""
    mha = fops.backward_scratch_shapes(4, 1024, 1024, 36, 36, 64, 1)
    assert mha == {"lse_delta": (4, 36, 16, 2, 64),
                   "dq_sums": (4, 36, 16, 64, 64),
                   "ticket": (1,), "turns": (4, 36, 16)}
    gqa = fops.backward_scratch_shapes(3, 1000, 1000, 32, 8, 128, 1)
    assert gqa == {"lse_delta": (3, 32, 16, 2, 64),
                   "dq_sums": (3, 32, 16, 64, 128),
                   "dkv_sums": (2, 3, 8, 1024, 128),
                   "ticket": (1,), "turns": (3, 32, 16),
                   "kv_turns": (3, 8, 8, 2)}
    for code, Dh in ((1, 16), (1, 80), (0, 64), (0, 128)):
        assert fops.backward_scratch_shapes(2, 100, 100, 8, 2, Dh, code) \
            == {"delta": (2, 8, 100)}


def test_backward_scratch_is_what_the_library_asks_for(monkeypatch):
    """The wrapper allocates the float32 scratch and the zeroed int32
    scratch the library sizes (a stand-in library here: the CPU builds
    none), and no int32 scratch where it asks for none."""
    asked = []

    def sizes(kind, n):
        def size(*args):
            asked.append((kind, args))
            return n
        return size

    for n_ints in (7, 0):
        monkeypatch.setattr(fops, "_bwd", (None, (sizes("floats", 11),
                                                  sizes("ints", n_ints)),
                                           None, None))
        fops._backward_scratch_sizes.cache_clear()
        q = torch.zeros((2, 100, 8, 64))
        k = torch.zeros((2, 90, 2, 64))
        scratch, ints = fops._backward_scratch(q, k, 1)
        assert scratch.dtype == torch.float32 and scratch.numel() == 11
        assert asked[-1] == ("ints", (2, 100, 90, 8, 2, 64, 1))
        if n_ints:
            assert ints.dtype == torch.int32 and ints.numel() == n_ints
            assert not ints.any()
        else:
            assert ints is None
    fops._backward_scratch_sizes.cache_clear()


def test_backward_source_adds_no_floats_atomically():
    """No float atomic and no float reduction in the backward or its
    helpers: the only atomics are the int32 ticket and turn counters."""
    for name in ("flash_backward.cu", "hopper.cuh"):
        text = (_build.CSRC / name).read_text()
        assert "atomicAdd" not in text and "cp.reduce" not in text
        ops = re.findall(r"\b(?:red|atom)\.[\w.:]+", text)
        assert all(op.endswith(".s32") for op in ops), ops


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _minicpm(n_layers=None):
    cfgs = AP.configs("minicpm-2b")
    if n_layers is not None:
        cfgs = [dataclasses.replace(c, n_layers=n_layers) for c in cfgs]
    return cfgs


def _batch(vocab, B=4, S=64, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _weights(rc, seed=0):
    npp = jax.tree.map(np.asarray, JM.init_params(rc, jax.random.key(seed)))
    AP._perturb_norms(npp, np.random.default_rng(seed))
    return npp


def _grads_match(rc, trc, npp, jb, tb, **tkw):
    jcfg = JT.TrainStepConfig(ce_chunk=32, **tkw)
    tcfg = TT.TrainStepConfig(ce_chunk=32, **tkw)
    (jl, ja), jg = jax.value_and_grad(JT.make_loss_fn(rc, jcfg),
                                      has_aux=True)(
        jax.tree.map(jnp.asarray, npp), jb)
    (tl, ta), tg = TS.make_grad_fn(trc, tcfg)(params_from_jax(npp, "cpu"),
                                              tb)
    _rel_close(jl, tl, 1e-5, "loss")
    for key in ("ce", "moe_aux"):
        _rel_close(ja[key], ta[key], 1e-5, key)
    assert int(ta["tokens"]) == int(ja["tokens"])
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(leaves(tg))
    for a, t in zip(jflat, leaves(tg)):
        assert t.dtype == torch.float32
        _rel_close(a, t, GRAD_TOL, f"grad {a.shape}")
    return float(tl)


@pytest.fixture(scope="module")
def steps4():
    """Reduced minicpm-2b, four steps of each package on the same weights
    and batch (WSD, lr 1e-3), and the port's params after each."""
    rc, trc = _minicpm()
    npp = _weights(rc)
    jb, tb = _batch(rc.vocab_size)
    sched = dict(warmup=2, stable=50, decay=20, peak_lr=LR)
    jstep = jax.jit(JT.make_train_step(rc, JT.TrainStepConfig(ce_chunk=32),
                                       JT.wsd_schedule(**sched)))
    tstep = TT.make_train_step(trc, TT.TrainStepConfig(ce_chunk=32),
                               TT.wsd_schedule(**sched))
    jp = jax.tree.map(jnp.asarray, npp)
    jo = JT.init_opt_state(jp)
    tp = params_from_jax(npp, device="cpu")
    to = TT.init_opt_state(tp)
    out = SimpleNamespace(jl=[], tl=[], jm=[], tm=[])
    for _ in range(STEPS):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        out.jl.append(float(jm["loss"]))
        out.tl.append(float(tm["loss"]))
        out.jm.append(jm)
        out.tm.append(tm)
    out.jp, out.tp, out.to = jp, tp, to
    return out


@pytest.mark.parametrize("n_layers", [None, 2], ids=["reduced", "2-layer"])
def test_step_one_loss_and_every_gradient_match_jax(n_layers):
    rc, trc = _minicpm(n_layers)
    jb, tb = _batch(rc.vocab_size)
    _grads_match(rc, trc, _weights(rc), jb, tb)


def test_four_steps_match_jax(steps4):
    np.testing.assert_allclose(steps4.tl, steps4.jl, rtol=1e-4)
    assert steps4.tl[-1] < steps4.tl[0]
    assert int(steps4.to["step"]) == STEPS
    for jm, tm in zip(steps4.jm, steps4.tm):
        for key in ("ce", "grad_norm", "lr"):
            _rel_close(jm[key], tm[key], 1e-4, key)
    for a, t in zip(jax.tree.leaves(steps4.jp), leaves(steps4.tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a),
                                   atol=4 * LR * STEPS, rtol=0)


def test_remat_equals_no_remat_bitwise():
    """Recomputing each block in the backward changes nothing."""
    _, trc = _minicpm(2)
    npp = _weights(dataclasses.replace(JREG["minicpm-2b"].reduced(),
                                       dtype="float32", n_layers=2))
    _, tb = _batch(trc.vocab_size)
    out = []
    for remat in (True, False):
        tcfg = TT.TrainStepConfig(ce_chunk=32, remat=remat)
        (loss, _), grads = TS.make_grad_fn(trc, tcfg)(
            params_from_jax(npp, "cpu"), tb)
        out.append((loss, leaves(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_adamw_in_slices_is_the_whole_update_bitwise(monkeypatch):
    """A leaf above ``SLICE`` elements is updated in views along its first
    dim; the update is elementwise, so params and moments come out with
    the same bits as one whole-leaf update."""
    from repro_torch.training import optimizer as TO

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((7, 5, 3), generator=g).to(torch.bfloat16),
              "b": torch.randn((4,), generator=g)}
    grads = {k: torch.randn(p.shape, generator=g).to(p.dtype)
             for k, p in params.items()}
    out = []
    for slice_ in (TO.SLICE, 16):
        monkeypatch.setattr(TO, "SLICE", slice_)
        p = {k: v.clone() for k, v in params.items()}
        st = TT.init_opt_state(p)
        for _ in range(2):
            p, st = TO.adamw_update(p, grads, st, TO.AdamWConfig(),
                                    torch.tensor(1e-3))
        out.append(leaves(p) + leaves(st))
    assert len(TO._slices(params["w"])) == 7  # 15 elements a row, 16 a slice
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_microbatches_match_jax():
    rc, trc = _minicpm()
    npp = _weights(rc, seed=2)
    jb, tb = _batch(rc.vocab_size, seed=3)
    sched = dict(warmup=5, total=100, peak_lr=LR)
    jstep = jax.jit(JT.make_train_step(
        rc, JT.TrainStepConfig(ce_chunk=32, microbatches=2),
        JT.cosine_schedule(**sched)))
    tstep = TT.make_train_step(
        trc, TT.TrainStepConfig(ce_chunk=32, microbatches=2),
        TT.cosine_schedule(**sched))
    jp = jax.tree.map(jnp.asarray, npp)
    jp, jo, jm = jstep(jp, JT.init_opt_state(jp), jb)
    tp = params_from_jax(npp, device="cpu")
    tp, to, tm = tstep(tp, TT.init_opt_state(tp), tb)
    for key in ("loss", "ce", "grad_norm"):
        _rel_close(jm[key], tm[key], 1e-5, key)
    for a, t in zip(jax.tree.leaves(jp), leaves(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=4 * LR,
                                   rtol=0)


def test_moe_loss_and_gradients_match_jax():
    """Reduced qwen3-moe: the CE plus 0.01 x the load-balancing loss,
    through the sorted dispatch and the combine in expert order."""
    rc, trc = AP.configs("qwen3-moe-30b-a3b")
    jb, tb = _batch(rc.vocab_size, B=2, S=32)
    loss = _grads_match(rc, trc, _weights(rc), jb, tb)
    assert np.isfinite(loss)


def test_gemma2_window_and_softcaps_match_jax():
    """Reduced gemma2 with its window set to 16: local and global layers,
    the attention softcap and the logit softcap."""
    rc, trc = AP.configs("gemma2-27b", window=16)
    assert rc.attn_softcap and rc.logit_softcap
    assert any(s.window == 16 for s in rc.block_pattern)
    jb, tb = _batch(rc.vocab_size, B=2, S=64)
    _grads_match(rc, trc, _weights(rc), jb, tb)


# ---------------------------------------------------------------------------
# AdamW, schedules, compression
# ---------------------------------------------------------------------------


def _ulps(a, b):
    """Largest distance in float32 ulps between two float32 arrays."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-2 ** 31) - ai, ai)
    bi = np.where(bi < 0, np.int64(-2 ** 31) - bi, bi)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("grad_clip", [1e3, 1.0, 0.05])
def test_adamw_update_matches_jax(grad_clip):
    """Three updates of a two-leaf tree from a nonzero state.  Unclipped
    (1e3), every param and moment is within 1 ulp of the reference's.
    Clipped (1.0, 0.05), the clip scale reads the global norm, a float32
    sum whose order differs between XLA and PyTorch by a few ulps (held
    at 1e-6 here), so the update is held at 1e-5 relative to each leaf's
    max (a moment near zero is the difference of two near-equal terms)."""
    rng = np.random.default_rng(7)
    tree = {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}
    cfg = dict(lr=3e-3, grad_clip=grad_clip)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    jo = JT.init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    to = TT.init_opt_state(tp)
    for i in range(3):
        g = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32)
             for k, v in tree.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        _rel_close(JT.optimizer.global_norm(jg), TT.optimizer.global_norm(
            tg), 1e-6, "global norm")
        lr = np.float32(3e-3 * (i + 1))
        jp, jo = JT.adamw_update(jp, jg, jo, JT.AdamWConfig(**cfg),
                                 jnp.float32(lr))
        tp, to = TT.adamw_update(tp, tg, to, TT.AdamWConfig(**cfg),
                                 torch.tensor(lr))
    assert int(to["step"]) == int(jo["step"]) == 3
    for key in tree:
        for want, got in ((jp[key], tp[key]), (jo["m"][key], to["m"][key]),
                          (jo["v"][key], to["v"][key])):
            if grad_clip > 100:
                assert _ulps(want, got.numpy()) <= 1, key
            else:
                _rel_close(want, got, 1e-5, key)


@pytest.mark.parametrize("name,args", [
    ("wsd_schedule", (10, 100, 50, 1e-3)),
    ("wsd_schedule", (1, 3, 2, 3e-4, 0.05)),
    ("cosine_schedule", (5, 100, 1e-3)),
    ("cosine_schedule", (0, 7, 2e-4, 0.2)),
])
def test_schedules_match_jax(name, args):
    """WSD within 1 ulp.  The cosine schedule's ``cos`` itself differs by
    up to 1 ulp between XLA and PyTorch, and ``min_frac + 0.45 (1 +
    cos)`` carries that absolute error into a smaller result near the
    end of the decay, so it is held at 5e-7 relative (a few ulps)."""
    jf, tf = getattr(JT.optimizer, name)(*args), getattr(TT, name)(*args)
    steps = np.arange(0, 200, dtype=np.int32)
    want = np.array([float(jf(jnp.int32(s))) for s in steps], np.float32)
    got = np.array([float(tf(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    if name == "wsd_schedule":
        assert _ulps(want, got) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


def test_wsd_schedule_shape():
    """tests/test_training.py::test_wsd_schedule_shape on the port."""
    f = TT.wsd_schedule(10, 100, 50, 1.0, min_lr_frac=0.1)
    assert float(f(torch.tensor(0))) == 0.0
    assert abs(float(f(torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(f(torch.tensor(60))) - 1.0) < 1e-6
    assert float(f(torch.tensor(160))) <= 0.11


def test_compress_matches_jax_bitwise():
    rng = np.random.default_rng(11)
    g = {"w": (rng.normal(size=(32, 48)) * 1e-3).astype(np.float32),
         "b": np.linspace(-1e-3, 1e-3, 48).astype(np.float32)}
    je = JT.init_error_state({k: jnp.asarray(v) for k, v in g.items()})
    te = TT.init_error_state({k: torch.from_numpy(v) for k, v in g.items()})
    for _ in range(3):
        jq, js, je = JT.compress({k: jnp.asarray(v) for k, v in g.items()},
                                 je)
        tq, ts, te = TT.compress({k: torch.from_numpy(v) for k, v in
                                  g.items()}, te)
        for key in g:
            assert tq[key].dtype == torch.int8
            np.testing.assert_array_equal(tq[key].numpy(), np.asarray(
                jq[key]))
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(
                js[key]))
            np.testing.assert_array_equal(te[key].numpy(), np.asarray(
                je[key]))
        jd, td = JT.decompress(jq, js), TT.decompress(tq, ts)
        for key in g:
            np.testing.assert_array_equal(td[key].numpy(), np.asarray(
                jd[key]))
    assert compressed_wire_bytes({k: torch.from_numpy(v) for k, v in
                                  g.items()}) == jax_wire(
        {k: jnp.asarray(v) for k, v in g.items()})


def test_compression_error_feedback_unbiased():
    """tests/test_training.py::test_compression_error_feedback_unbiased on
    the port: 16 compressed steps sum to 16 x the gradient within 2%."""
    g = {"w": torch.full((64, 64), 3.3e-4),
         "b": torch.linspace(-1e-3, 1e-3, 64)}
    err = TT.init_error_state(g)
    acc = {k: torch.zeros_like(v) for k, v in g.items()}
    for _ in range(16):
        q, s, err = TT.compress(g, err)
        d = TT.decompress(q, s)
        acc = {k: acc[k] + d[k] for k in g}
    for k in g:
        rel = float((acc[k] - 16 * g[k]).abs().max()) / (
            16 * float(g[k].abs().max()) + 1e-12)
        assert rel < 0.02, k


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_tree():
    """A bf16 reduced-minicpm param tree with its optimizer state, as
    numpy leaves (ml_dtypes' bfloat16) and as the port's tensors."""
    rc = JREG["minicpm-2b"].reduced()
    jp = JM.init_params(rc, jax.random.key(4))
    jtree = {"params": jp, "opt": JT.init_opt_state(jp)}
    jtree["opt"]["step"] = jnp.int32(7)
    np_tree = jax.tree.map(np.asarray, jtree)
    ttree = {"params": params_from_jax(np_tree["params"], "cpu"),
             "opt": {"m": params_from_jax(np_tree["opt"]["m"], "cpu"),
                     "v": params_from_jax(np_tree["opt"]["v"], "cpu"),
                     "step": torch.tensor(7, dtype=torch.int32)}}
    return np_tree, ttree


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
        return x
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _same_bits(a_tree, b_tree):
    """Equal bits leaf for leaf; both trees flatten in JAX's order."""
    a, b = leaves(a_tree), leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_checkpoint_roundtrip_retention_and_async(bf16_tree, tmp_path):
    _, tree = bf16_tree
    mgr = TT.CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for s in (10, 20, 30):
        mgr.save(s, tree, meta={"loss": 1.0 / s})
    mgr.wait()
    assert mgr.steps() == [20, 30]
    restored, step = mgr.restore_latest(tree)
    assert step == 30
    assert TC.load_meta(mgr._step_dir(30)) == {"loss": 1.0 / 30, "step": 30}
    for a, b in zip(leaves(restored), leaves(tree)):
        assert a.dtype == b.dtype and a.device.type == "cpu"
    _same_bits(restored, tree)
    on_cpu, _ = mgr.restore_latest(tree, device="cpu")
    _same_bits(on_cpu, tree)


def test_a_jax_checkpoint_restores_in_the_port(bf16_tree, tmp_path):
    np_tree, ttree = bf16_tree
    path = str(tmp_path / "step_00000001")
    JT.save(path, np_tree, meta={"from": "jax"})
    got = TC.restore(path, ttree)
    assert leaves(got)[-1].dtype == torch.bfloat16  # params/final_norm
    _same_bits(np_tree, got)
    assert TC.load_meta(path) == {"from": "jax"}


def test_a_port_checkpoint_restores_in_jax(bf16_tree, tmp_path):
    np_tree, ttree = bf16_tree
    path = str(tmp_path / "step_00000002")
    TC.save(path, ttree, meta={"from": "port"})
    got = JT.restore(path, np_tree)
    assert jax.tree.leaves(got)[-1].dtype.name == "bfloat16"
    _same_bits(got, ttree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(np_tree))
    assert manifest["treedef"] == treedef_str(ttree)


# ---------------------------------------------------------------------------
# What the port does not train yet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,quantize,item", [
    ("llama-3.1-8b", True, "item 6"),
])
def test_untrainable_configs_raise_before_any_step(arch, quantize, item):
    cfg = dataclasses.replace(TREG[arch].reduced(), dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    if quantize:
        params = TM.quantize_params(params)
    opt = {"step": torch.zeros((), dtype=torch.int32)}
    _, tb = _batch(cfg.vocab_size, B=1, S=32)
    step = TT.make_train_step(cfg, TT.TrainStepConfig(ce_chunk=32),
                              TT.wsd_schedule(1, 1, 1, LR))
    with pytest.raises(NotImplementedError, match=item):
        step(params, opt, tb)
    assert int(opt["step"]) == 0


def test_training_on_a_wide_mesh_raises():
    cfg = dataclasses.replace(TREG["minicpm-2b"].reduced(), dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    wide = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    with mesh_context(wide):
        with pytest.raises(NotImplementedError, match="item 13"):
            TM.check_trainable(cfg, params)
    TM.check_trainable(cfg, params)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------


def _train(tmp_path, steps):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", str(steps), "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=180, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    return run.stdout


def test_launch_train_checkpoints_and_resumes(tmp_path):
    out = _train(tmp_path, 3)
    assert re.search(r"^step 1/3 loss=\d+\.\d{4} lr=\S+ gnorm=\S+ "
                     r"\(\d+\.\ds\)$", out, re.M), out
    assert out.strip().endswith("done")
    assert "resumed" not in out
    mgr = TT.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.steps() == [2, 3]
    out = _train(tmp_path, 5)
    assert "resumed from step 3" in out, out
    assert re.search(r"^step 4/5 ", out, re.M), out
    assert mgr.steps() == [3, 4, 5]


def test_synthetic_batch_is_the_references():
    from repro.launch.train import synthetic_batch as jax_batch
    from repro_torch.launch.train import synthetic_batch

    j = jax_batch(np.random.default_rng(5), 257, 3, 16)
    t = synthetic_batch(np.random.default_rng(5), 257, 3, 16)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))
