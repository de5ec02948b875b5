"""Each ported layer function against ``repro.models.layers`` on the same
numpy inputs, in float32 and bfloat16 (tolerances of
tests/test_kernels.py:18)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(x: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounds identically)."""
    x = np.asarray(x, np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(j, t, dtype, scale=1.0):
    tol = TOL[dtype] * scale
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)) * 3.0, dtype)
    wj, wt = _pair(rng.normal(size=(64,)) * 0.1, dtype)
    _close(JL.rms_norm(xj, wj, 1e-6), TL.rms_norm(xt, wt, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    sj, cj = JL.rope_sincos(jnp.asarray(pos), 16, 500_000.0)
    st, ct = TL.rope_sincos(torch.from_numpy(pos), 16, 500_000.0)
    _close(sj, st, "float32", scale=10)  # sin of angles up to ~4000 rad
    _close(cj, ct, "float32", scale=10)
    xj, xt = _pair(rng.normal(size=(2, 7, 4, 16)), dtype)
    # rotate with the same sin/cos so only apply_rope is compared
    s = np.array(sj)
    c = np.array(cj)
    out_j = JL.apply_rope(xj, jnp.asarray(s), jnp.asarray(c))
    out_t = TL.apply_rope(xt, torch.from_numpy(s), torch.from_numpy(c))
    _close(out_j, out_t, dtype)


def test_softcap():
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    _close(JL._softcap(jnp.asarray(x), 30.0),
           TL._softcap(torch.from_numpy(x), 30.0), "float32")
    assert TL._softcap(torch.from_numpy(x), None) is not None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,softcap,ragged", [
    (None, None, False), (None, None, True), (24, None, True),
    (None, 30.0, False), (24, 50.0, True),
])
def test_chunked_attention(dtype, window, softcap, ragged):
    rng = np.random.default_rng(2)
    B, S, Hq, Hkv, Dh = 2, 64, 4, 2, 16
    qj, qt = _pair(rng.normal(size=(B, S, Hq, Dh)), dtype)
    kj, kt = _pair(rng.normal(size=(B, S, Hkv, Dh)), dtype)
    vj, vt = _pair(rng.normal(size=(B, S, Hkv, Dh)), dtype)
    valid = None
    if ragged:
        valid = np.arange(S)[None] < np.array([[40], [64]])
    kw = dict(causal=True, window=window, softcap=softcap, q_chunk=32,
              k_chunk=16)
    out_j = JL.chunked_attention(
        qj, kj, vj, kv_valid=None if valid is None else jnp.asarray(valid),
        **kw)
    out_t = TL.chunked_attention(
        qt, kt, vt,
        kv_valid=None if valid is None else torch.from_numpy(valid), **kw)
    assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,softcap", [(None, None), (12, 30.0)])
def test_decode_attention(dtype, window, softcap):
    rng = np.random.default_rng(3)
    B, C, Hq, Hkv, Dh = 3, 32, 4, 2, 16
    qj, qt = _pair(rng.normal(size=(B, Hq, Dh)), dtype)
    kj, kt = _pair(rng.normal(size=(B, C, Hkv, Dh)), dtype)
    vj, vt = _pair(rng.normal(size=(B, C, Hkv, Dh)), dtype)
    filled = np.array([20, 32, 0])  # the last row is an empty slot
    slot_pos = np.where(np.arange(C)[None] < filled[:, None],
                        np.arange(C)[None], -1).astype(np.int32)
    q_pos = np.maximum(filled - 1, 0).astype(np.int32)
    kw = dict(window=window, softcap=softcap)
    out_j = JL.decode_attention(qj, kj, vj, jnp.asarray(slot_pos),
                                jnp.asarray(q_pos), **kw)
    out_t = TL.decode_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                                torch.from_numpy(q_pos), **kw)
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_mlp(dtype, act):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.normal(size=(2, 3, 64)), dtype)
    ws = [_pair(rng.normal(size=s) * 0.1, dtype)
          for s in ((64, 128), (64, 128), (128, 64))]
    out_j = JL.glu_mlp(xj, *(w[0] for w in ws), act)
    out_t = TL.glu_mlp(xt, *(w[1] for w in ws), act)
    _close(out_j, out_t, dtype)
