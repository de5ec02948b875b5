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
@pytest.mark.parametrize("T", [1, 3, 5])
@pytest.mark.parametrize("window,softcap", [(None, None), (12, 30.0)])
def test_verify_attention(dtype, T, window, softcap):
    """T new tokens per sequence over a cache that holds their K/V,
    causal within the window; the last row mixes empty slots in."""
    rng = np.random.default_rng(6)
    B, C, Hq, Hkv, Dh = 3, 32, 4, 2, 16
    qj, qt = _pair(rng.normal(size=(B, T, Hq, Dh)), dtype)
    kj, kt = _pair(rng.normal(size=(B, C, Hkv, Dh)), dtype)
    vj, vt = _pair(rng.normal(size=(B, C, Hkv, Dh)), dtype)
    filled = np.array([20, 32, 9])
    slot_pos = np.where(np.arange(C)[None] < filled[:, None],
                        np.arange(C)[None], -1).astype(np.int32)
    q_pos = (filled[:, None] - T + np.arange(T)[None]).astype(np.int32)
    kw = dict(window=window, softcap=softcap)
    out_j = JL.verify_attention(qj, kj, vj, jnp.asarray(slot_pos),
                                jnp.asarray(q_pos), **kw)
    out_t = TL.verify_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                                torch.from_numpy(q_pos), **kw)
    assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
    _close(out_j, out_t, dtype)
    if T == 1:  # T == 1 is decode_attention
        dec = TL.decode_attention(qt[:, 0], kt, vt,
                                  torch.from_numpy(slot_pos),
                                  torch.from_numpy(q_pos[:, 0]), **kw)
        torch.testing.assert_close(out_t[:, 0], dec, atol=0, rtol=0)


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


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer layers
# ---------------------------------------------------------------------------


def _ssd(rng, B, S, H, P, N, dtype):
    x = _pair(rng.normal(size=(B, S, H, P)), dtype)
    dt = _pair(np.log1p(np.exp(rng.normal(size=(B, S, H)))), "float32")
    A = _pair(-np.exp(rng.normal(size=(H,)) * 0.3), "float32")
    Bm = _pair(rng.normal(size=(B, S, N)) * 0.3, dtype)
    Cm = _pair(rng.normal(size=(B, S, N)) * 0.3, dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "init"])
def test_ssd_chunked(dtype, with_state):
    """The loop over chunks against the JAX associative scan, with and
    without a carried-in state.  Float32 to 2e-5 of the output's scale
    (the chunk states sum in another order); bf16 to the bf16 rounding of
    y."""
    rng = np.random.default_rng(7)
    B, S, H, P, N, chunk = 2, 96, 3, 16, 8, 32
    args = _ssd(rng, B, S, H, P, N, dtype)
    kw_j, kw_t = {}, {}
    if with_state:
        sj, st = _pair(rng.normal(size=(B, H, P, N)), "float32")
        kw_j, kw_t = dict(init_state=sj), dict(init_state=st)
    yj, fj = JL.ssd_chunked(*(a[0] for a in args), chunk=chunk, **kw_j)
    yt, ft = TL.ssd_chunked(*(a[1] for a in args), chunk=chunk, **kw_t)
    assert yt.dtype == args[0][1].dtype and ft.dtype == torch.float32
    scale = float(np.abs(np.asarray(yj, np.float32)).max())
    _close(yj, yt, dtype, scale=scale)
    _close(fj, ft, "float32", scale=float(np.abs(np.asarray(fj)).max()))
    with pytest.raises(ValueError, match="chunk must divide"):
        TL.ssd_chunked(*(a[1] for a in args), chunk=64)


def test_ssd_chunked_is_the_token_recurrence():
    """Chunking is exact algebra: the layer equals the port's token
    recurrence (the kernel's plain version) from a zero state."""
    from repro_torch.kernels.ssd import ssd_ref

    rng = np.random.default_rng(8)
    args = [a[1] for a in _ssd(rng, 2, 128, 4, 16, 16, "float32")]
    y, st = TL.ssd_chunked(*args, chunk=32)
    yr, sr = ssd_ref(*args)
    torch.testing.assert_close(y, yr, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(st, sr, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step(dtype):
    rng = np.random.default_rng(9)
    B, H, P, N = 3, 4, 16, 8
    xj, xt = _pair(rng.normal(size=(B, H, P)), dtype)
    dj, dt = _pair(np.log1p(np.exp(rng.normal(size=(B, H)))), "float32")
    aj, at = _pair(-np.exp(rng.normal(size=(H,)) * 0.3), "float32")
    bj, bt = _pair(rng.normal(size=(B, N)) * 0.3, dtype)
    cj, ct = _pair(rng.normal(size=(B, N)) * 0.3, dtype)
    sj, st = _pair(rng.normal(size=(B, H, P, N)), "float32")
    yj, nj = JL.ssd_decode_step(xj, dj, aj, bj, cj, sj)
    yt, nt = TL.ssd_decode_step(xt, dt, at, bt, ct, st)
    assert yt.dtype == xt.dtype and nt.dtype == torch.float32
    _close(yj, yt, dtype, scale=10)  # |y| is a few units
    _close(nj, nt, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_and_conv_step(dtype):
    """The full-sequence conv against JAX, and the decode-time step: fed
    the sequence token by token from a zero state, it reproduces the
    full conv and leaves the last K-1 inputs as its state."""
    rng = np.random.default_rng(10)
    B, S, D, K = 2, 9, 24, 4
    xj, xt = _pair(rng.normal(size=(B, S, D)), dtype)
    wj, wt = _pair(rng.normal(size=(D, K)) * 0.5, dtype)
    full_t = TL.causal_conv1d(xt, wt)
    _close(JL.causal_conv1d(xj, wj), full_t, dtype)
    state_j = jnp.zeros((B, K - 1, D), xj.dtype)
    state_t = torch.zeros((B, K - 1, D), dtype=xt.dtype)
    for t in range(S):
        yj, state_j = JL.conv_step(xj[:, t], state_j, wj)
        yt, state_t = TL.conv_step(xt[:, t], state_t, wt)
        _close(yj, yt, dtype)
        _close(state_j, state_t, dtype)
        torch.testing.assert_close(yt, full_t[:, t], atol=0, rtol=0)
    torch.testing.assert_close(state_t, xt[:, S - K + 1:], atol=0, rtol=0)
