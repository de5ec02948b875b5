"""The port's kernel wrappers against the JAX oracles and the Pallas
kernels (interpret mode on CPU, as tests/test_kernels.py runs them).

On the CPU a wrapper takes its kernel's plain PyTorch version;
tests/test_torch_cuda.py holds the Hopper kernels against those plain
versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    decode_attention as pallas_decode,
    decode_attention_ref as jax_decode_ref,
)
from repro.kernels.flash_attention import (
    attention_ref as jax_attention_ref,
    flash_attention as pallas_flash,
)
from repro.models import layers as JL
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18


def _pair(x, dtype):
    x = np.asarray(x, np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(j, t, dtype):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype],
    )


def _qkv(rng, B, Sq, Skv, Hq, Hkv, Dh, dtype):
    return (_pair(rng.normal(size=(B, Sq, Hq, Dh)), dtype),
            _pair(rng.normal(size=(B, Skv, Hkv, Dh)), dtype),
            _pair(rng.normal(size=(B, Skv, Hkv, Dh)), dtype))


# ---------------------------------------------------------------------------
# prefill flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [
    (2, 256, 4, 4, 64),      # MHA
    (1, 512, 8, 2, 64),      # GQA 4:1
    (2, 256, 6, 2, 128),     # GQA 3:1, 128-dim heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [
    (None, None), (128, None), (None, 30.0), (64, 50.0),
])
def test_flash_wrapper_matches_jax_ref_and_pallas(B, S, Hq, Hkv, Dh, dtype,
                                                  window, softcap):
    """The sweep of tests/test_kernels.py:21-41: the wrapper (plain path on
    CPU) against ``attention_ref``, and against the Pallas kernel in
    interpret mode where both window and softcap are on (each interpret
    call compiles anew, so the Pallas half covers one cell per shape)."""
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, S, S, Hq, Hkv, Dh, dtype)
    kw = dict(causal=True, window=window, softcap=softcap)
    n0 = fops.launches
    out = flash_attention(qt, kt, vt, **kw)
    assert fops.launches == n0  # the CPU path launches nothing
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(jax_attention_ref(qj, kj, vj, **kw), out, dtype)
    if window is not None and softcap is not None:
        _close(pallas_flash(qj, kj, vj, block_q=128, block_k=128, **kw), out,
               dtype)


@pytest.mark.parametrize("S,dtype,window,softcap", [
    (96, "float32", None, None), (96, "bfloat16", 48, 30.0),
    (200, "bfloat16", None, None), (200, "float32", 48, 30.0),
])
def test_flash_ragged_kv_len_matches_chunked_attention(S, dtype, window,
                                                       softcap):
    """Ragged S (no multiple of any block) and per-row ``kv_len``: the
    model's prefill call, equal to ``L.chunked_attention`` with
    ``kv_valid = pos < kv_len`` — pad query rows included."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, Dh = 3, 8, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, S, S, Hq, Hkv, Dh, dtype)
    lens = np.array([S, S // 2 + 3, 1], np.int32)
    valid = np.arange(S)[None] < lens[:, None]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = JL.chunked_attention(
        qj, kj, vj, causal=True, window=window, softcap=softcap,
        q_positions=pos, kv_positions=pos, kv_valid=jnp.asarray(valid),
    )
    got = flash_attention(qt, kt, vt, causal=True, window=window,
                          softcap=softcap, kv_len=torch.from_numpy(lens))
    _close(want, got, dtype)


def test_flash_fully_masked_rows_average_v():
    """A row with no valid key (kv_len = 0) averages V over every key, as
    the reference's finite -1e30 masking does — never 0 or NaN."""
    rng = np.random.default_rng(2)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 2, 24, 24, 4, 2, 16, "float32")
    out = flash_attention(qt, kt, vt, kv_len=torch.tensor([0, 24],
                                                          dtype=torch.int32))
    mean_v = vt[0].mean(dim=0).repeat_interleave(2, dim=0)  # (Hq, Dh)
    torch.testing.assert_close(out[0], mean_v.expand(24, 4, 16),
                               atol=2e-5, rtol=2e-5)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# ring decode attention
# ---------------------------------------------------------------------------


def _ring(rng, B, C, Hq, Hkv, Dh, dtype, filled):
    qj, qt = _pair(rng.normal(size=(B, Hq, Dh)), dtype)
    kj, kt = _pair(rng.normal(size=(B, C, Hkv, Dh)), dtype)
    vj, vt = _pair(rng.normal(size=(B, C, Hkv, Dh)), dtype)
    slot_pos = np.where(np.arange(C)[None] < filled[:, None],
                        np.arange(C)[None], -1).astype(np.int32)
    return (qj, qt), (kj, kt), (vj, vt), slot_pos


@pytest.mark.parametrize("B,C,Hq,Hkv,Dh,block_c", [
    (2, 512, 4, 4, 64, 128),
    (3, 1024, 8, 2, 64, 256),
    (1, 256, 6, 2, 128, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_wrapper_matches_jax_ref_and_pallas(B, C, Hq, Hkv, Dh,
                                                   block_c, dtype):
    """The sweep of tests/test_kernels.py:44-66."""
    rng = np.random.default_rng(3)
    filled = rng.integers(C // 4, C, size=B)
    (qj, qt), (kj, kt), (vj, vt), slot_pos = _ring(rng, B, C, Hq, Hkv, Dh,
                                                   dtype, filled)
    q_pos = filled.astype(np.int32)
    n0 = dops.launches
    out = decode_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                           torch.from_numpy(q_pos))
    assert dops.launches == n0
    args = (qj, kj, vj, jnp.asarray(slot_pos), jnp.asarray(q_pos))
    _close(jax_decode_ref(*args), out, dtype)
    _close(pallas_decode(*args, block_c=block_c), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_all_empty_row_is_mean_of_v(dtype):
    """A free decode slot (every position -1) returns the mean of V over
    the C slots, as the reference and the Pallas kernel do."""
    rng = np.random.default_rng(4)
    B, C, Hq, Hkv, Dh = 3, 64, 8, 2, 32
    filled = np.array([40, 0, 64])
    (qj, qt), (kj, kt), (vj, vt), slot_pos = _ring(rng, B, C, Hq, Hkv, Dh,
                                                   dtype, filled)
    q_pos = np.maximum(filled - 1, 0).astype(np.int32)
    out = decode_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                           torch.from_numpy(q_pos), softcap=30.0)
    mean_v = vt[1].float().mean(dim=0).repeat_interleave(Hq // Hkv, dim=0)
    np.testing.assert_allclose(out[1].float().numpy(), mean_v.numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    args = (qj, kj, vj, jnp.asarray(slot_pos), jnp.asarray(q_pos))
    _close(pallas_decode(*args, softcap=30.0, block_c=64), out, dtype)


def test_decode_ring_buffer_wraparound():
    """tests/test_kernels.py:218-234: positions past the capacity."""
    rng = np.random.default_rng(5)
    B, C, H, Dh = 1, 64, 2, 32
    (qj, qt), (kj, kt), (vj, vt), _ = _ring(rng, B, C, H, H, Dh, "float32",
                                            np.array([C]))
    qp = 100
    slots = np.arange(C)
    slot_pos = np.where(slots <= qp % C, qp - qp % C + slots,
                        qp - qp % C - C + slots)[None].astype(np.int32)
    q_pos = np.array([qp], np.int32)
    out = decode_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                           torch.from_numpy(q_pos), window=48)
    want = jax_decode_ref(qj, kj, vj, jnp.asarray(slot_pos),
                          jnp.asarray(q_pos), window=48)
    _close(want, out, "float32")
