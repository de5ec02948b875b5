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
    paged_decode_attention as pallas_paged_decode,
    paged_decode_attention_ref as jax_paged_decode_ref,
    paged_verify_attention as pallas_paged_verify,
    paged_verify_attention_ref as jax_paged_verify_ref,
)
from repro.kernels.flash_attention import (
    attention_ref as jax_attention_ref,
    flash_attention as pallas_flash,
)
from repro.models import layers as JL
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.kernels.decode_attention import ops as dops
from repro.kernels.ssd import ssd_ref as jax_ssd_ref
from repro.kernels.ssd import ssd_scan as pallas_ssd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd import ssd_ref, ssd_scan
from repro_torch.kernels.ssd import ops as sops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18
# the SSD scan's tolerances, scale-normalised (tests/test_kernels.py:256)
SSD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


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



# ---------------------------------------------------------------------------
# prefill flash attention with a query offset (paged prefill after a hit)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_flash_q_offset_matches_chunked_attention(dtype, window, softcap):
    """Query row i at position ctx + i over the gathered table (key j at
    position j), kv_len = ctx + new: ``L.chunked_attention`` with
    ``q_positions = ctx + i`` and ``kv_valid = pos < kv_len``."""
    rng = np.random.default_rng(7)
    B, S, Skv, Hq, Hkv, Dh = 3, 24, 64, 8, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, S, Skv, Hq, Hkv, Dh, dtype)
    ctx = np.array([0, 16, 32], np.int32)
    new = np.array([24, 7, 1], np.int32)
    qpos = (ctx[:, None] + np.arange(S)[None]).astype(np.int32)
    kpos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv))
    valid = kpos < (ctx + new)[:, None]
    want = JL.chunked_attention(
        qj, kj, vj, causal=True, window=window, softcap=softcap,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        kv_valid=jnp.asarray(valid), q_chunk=S, k_chunk=Skv,
    )
    got = flash_attention(qt, kt, vt, causal=True, window=window,
                          softcap=softcap,
                          kv_len=torch.from_numpy(ctx + new),
                          q_start=torch.from_numpy(ctx))
    _close(want, got, dtype)


def test_flash_q_start_zero_equals_no_offset():
    rng = np.random.default_rng(8)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 2, 40, 40, 4, 2, 16, "float32")
    kl = torch.tensor([40, 22], dtype=torch.int32)
    a = flash_attention(qt, kt, vt, kv_len=kl)
    b = flash_attention(qt, kt, vt, kv_len=kl,
                        q_start=torch.zeros(2, dtype=torch.int32))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# paged decode and speculative verify (tests/test_kernels.py:69-216)
# ---------------------------------------------------------------------------


def _paged(rng, B, T, P, ps, Hq, Hkv, Dh, Pmax, lengths, dtype):
    """Pool, queries and shuffled disjoint tables (-1 past each row's
    last page), the same values on both sides."""
    qj, qt = _pair(rng.normal(size=(B, T, Hq, Dh)), dtype)
    kj, kt = _pair(rng.normal(size=(P, ps, Hkv, Dh)), dtype)
    vj, vt = _pair(rng.normal(size=(P, ps, Hkv, Dh)), dtype)
    perm = rng.permutation(P)
    bt = np.full((B, Pmax), -1, np.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        bt[b, :n] = perm[b * Pmax: b * Pmax + n]
    ln = np.asarray(lengths, np.int32)
    return ((qj, qt), (kj, kt), (vj, vt),
            (jnp.asarray(bt), torch.from_numpy(bt)),
            (jnp.asarray(ln), torch.from_numpy(ln)))


@pytest.mark.parametrize("P,ps,Hq,Hkv,Dh,Pmax", [
    (24, 16, 4, 4, 64, 4),    # MHA
    (32, 8, 8, 2, 64, 6),     # GQA 4:1
    (16, 16, 6, 2, 128, 3),   # GQA 3:1, 128-dim heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [
    (None, None), (24, None), (None, 30.0),
])
def test_paged_decode_wrapper_matches_jax_ref_and_pallas(P, ps, Hq, Hkv, Dh,
                                                         Pmax, dtype, window,
                                                         softcap):
    """The sweep of tests/test_kernels.py:78-105 (ragged lengths); the
    Pallas kernel in interpret mode on the unwindowed, uncapped cell of
    each shape (each interpret call compiles anew)."""
    rng = np.random.default_rng(9)
    B = 3
    lengths = [1 + (ps * Pmax) // 3, ps * Pmax - 1, ps + 1]
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _paged(
        rng, B, 1, P, ps, Hq, Hkv, Dh, Pmax, lengths, dtype)
    kw = dict(window=window, softcap=softcap)
    n0 = dict(dops.paged_launches)
    out = paged_decode_attention(qt[:, 0], kt, vt, bt, lt, **kw)
    assert dops.paged_launches == n0  # the CPU path launches nothing
    assert out.dtype == qt.dtype and out.shape == qt[:, 0].shape
    _close(jax_paged_decode_ref(qj[:, 0], kj, vj, bj, lj, **kw), out, dtype)
    if window is None and softcap is None:
        _close(pallas_paged_decode(qj[:, 0], kj, vj, bj, lj, **kw), out,
               dtype)


@pytest.mark.parametrize("extra", [0, 1])
def test_paged_decode_page_boundary(extra):
    """len % page_size in {0, 1} (tests/test_kernels.py:108-127)."""
    rng = np.random.default_rng(10)
    P, ps, Hkv, Dh, Hq, B, Pmax = 12, 8, 2, 32, 4, 2, 3
    L = 2 * ps + extra
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _paged(
        rng, B, 1, P, ps, Hq, Hkv, Dh, Pmax, [L, L], "float32")
    out = paged_decode_attention(qt[:, 0], kt, vt, bt, lt)
    _close(jax_paged_decode_ref(qj[:, 0], kj, vj, bj, lj), out, "float32")
    _close(pallas_paged_decode(qj[:, 0], kj, vj, bj, lj), out, "float32")


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [
    (None, None), (24, None), (None, 30.0),
])
def test_paged_verify_wrapper_matches_jax_ref_and_pallas(k, dtype, window,
                                                         softcap):
    """The sweep of tests/test_kernels.py:130-157: T = k + 1 query rows,
    causal within the speculation window; Pallas on one cell per k."""
    rng = np.random.default_rng(11)
    P, ps, Hq, Hkv, Dh, Pmax, B = 32, 8, 8, 2, 64, 6, 3
    T = k + 1
    lengths = [T + 1, (ps * Pmax) // 2, ps * Pmax - 1]
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _paged(
        rng, B, T, P, ps, Hq, Hkv, Dh, Pmax, lengths, dtype)
    kw = dict(window=window, softcap=softcap)
    out = paged_verify_attention(qt, kt, vt, bt, lt, **kw)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(jax_paged_verify_ref(qj, kj, vj, bj, lj, **kw), out, dtype)
    if window is None and softcap is None and dtype == "float32":
        _close(pallas_paged_verify(qj, kj, vj, bj, lj, **kw), out, dtype)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("extra", [0, 1])
def test_paged_verify_page_boundary(k, extra):
    """The window straddling a page boundary
    (tests/test_kernels.py:160-182)."""
    rng = np.random.default_rng(12)
    P, ps, Hkv, Dh, Hq, B, Pmax = 16, 8, 2, 32, 4, 2, 4
    L = 2 * ps + extra
    (qj, qt), (kj, kt), (vj, vt), (bj, bt), (lj, lt) = _paged(
        rng, B, k + 1, P, ps, Hq, Hkv, Dh, Pmax, [L, L], "float32")
    out = paged_verify_attention(qt, kt, vt, bt, lt)
    _close(jax_paged_verify_ref(qj, kj, vj, bj, lj), out, "float32")


def test_paged_verify_t1_equals_paged_decode():
    """tests/test_kernels.py:185-199: bit-exact."""
    rng = np.random.default_rng(13)
    (_, qt), (_, kt), (_, vt), (_, bt), (_, lt) = _paged(
        rng, 2, 1, 12, 8, 4, 2, 32, 3, [8 + 3, 3 * 8], "float32")
    ver = paged_verify_attention(qt, kt, vt, bt, lt)
    dec = paged_decode_attention(qt[:, 0], kt, vt, bt, lt)
    assert torch.equal(ver[:, 0], dec)


def test_paged_matches_ring_decode_attention():
    """tests/test_kernels.py:202-215: the paged and ring layouts are two
    views of one cache."""
    rng = np.random.default_rng(14)
    ps, n_pages, Hkv, Dh, Hq = 8, 4, 2, 32, 4
    C = ps * n_pages
    (_, qt), (_, kt), (_, vt), _ = _ring(rng, 1, C, Hq, Hkv, Dh, "float32",
                                         np.array([C]))
    L = 19
    slot_pos = np.where(np.arange(C) < L, np.arange(C), -1)[None]
    ring = decode_attention(qt, kt, vt,
                            torch.from_numpy(slot_pos.astype(np.int32)),
                            torch.tensor([L - 1], dtype=torch.int32))
    paged = paged_decode_attention(
        qt, kt.reshape(n_pages, ps, Hkv, Dh), vt.reshape(n_pages, ps, Hkv, Dh),
        torch.arange(n_pages, dtype=torch.int32)[None],
        torch.tensor([L], dtype=torch.int32))
    torch.testing.assert_close(paged, ring, atol=2e-5, rtol=2e-5)


def test_paged_wrapper_rejects_mismatched_tables():
    q = torch.zeros((2, 3, 4, 16))
    pool = torch.zeros((5, 8, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        paged_verify_attention(q, pool, pool,
                               torch.zeros((3, 2), dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match"):
        paged_verify_attention(q, pool[..., :8], pool[..., :8],
                               torch.zeros((2, 2), dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32))


def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` names a new library, so it rebuilds."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    header.write_text("// v2\n")
    assert _build.library_path("k") != first
    header.write_text("// v1\n")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.library_path("k") != first


def test_shared_memory_opt_in_is_per_device():
    """The dynamic shared-memory attribute is per device: every kernel
    sets it through ``mma::opt_in_smem``, which records each device, and
    no source guards ``cudaFuncSetAttribute`` with a once-per-process
    flag."""
    from repro_torch.kernels import _build

    calls = {}
    for src in sorted(_build.CSRC.glob("*.cu*")):
        text = src.read_text()
        assert "static bool configured" not in text, src.name
        calls[src.name] = text.count("cudaFuncSetAttribute(")
    assert calls.pop("mma_bf16.cuh") == 1  # inside opt_in_smem
    assert not any(calls.values()), calls
    for name in _build.KERNELS:
        assert "mma::opt_in_smem(" in (_build.CSRC / f"{name}.cu").read_text()


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, B, S, H, P, N, dtype):
    """tests/test_kernels.py:244-249, drawn with numpy: x, B and C in the
    working dtype, dt (post-softplus) and A (negative) in float32."""
    x = _pair(rng.normal(size=(B, S, H, P)), dtype)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = _pair(rng.normal(size=(B, S, N)) * 0.3, dtype)
    Cm = _pair(rng.normal(size=(B, S, N)) * 0.3, dtype)
    return (x, _pair(dt, "float32"), _pair(A, "float32"), Bm, Cm)


def _close_scaled(want, got, dtype):
    """Scale-normalised agreement, as tests/test_kernels.py:256-262."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               atol=SSD_TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 4, 64, 128, 64),
    (1, 512, 8, 32, 64, 128),
    (2, 128, 2, 64, 32, 128),  # chunk == S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_wrapper_matches_jax_ref_and_pallas(B, S, H, P, N, chunk, dtype):
    """The sweep of tests/test_kernels.py:237-262: the wrapper (the token
    recurrence on CPU) against the JAX ``ssd_ref`` and the Pallas kernel
    in interpret mode, y and the final state."""
    rng = np.random.default_rng(3)
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        rng, B, S, H, P, N, dtype)
    n0 = sops.launches
    y, st = ssd_scan(xt, dtt, at, bt, ct, chunk=chunk)
    assert sops.launches == n0  # the CPU path launches nothing
    assert y.dtype == xt.dtype and y.shape == xt.shape
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    yr, sr = jax_ssd_ref(xj, dj, aj, bj, cj)
    _close_scaled(yr, y, dtype)
    _close_scaled(sr, st, dtype)
    yp, sp = pallas_ssd(xj, dj, aj, bj, cj, chunk=chunk)
    _close_scaled(yp, y, dtype)
    _close_scaled(sp, st, dtype)


def test_ssd_wrapper_keeps_the_pallas_contract():
    """``chunk = min(chunk, S)`` must divide S (ValueError, where the
    Pallas wrapper asserts); a short sequence takes one chunk."""
    rng = np.random.default_rng(4)
    args = [t for _, t in _ssd_inputs(rng, 1, 96, 2, 16, 16, "float32")]
    with pytest.raises(ValueError, match="chunk must divide"):
        ssd_scan(*args, chunk=64)
    y, st = ssd_scan(*args, chunk=256)  # chunk becomes S
    yr, sr = ssd_ref(*args)
    torch.testing.assert_close(y, yr, atol=0, rtol=0)
    torch.testing.assert_close(st, sr, atol=0, rtol=0)
    with pytest.raises(ValueError, match="does not match"):
        ssd_scan(args[0], args[1][:, :, :1], *args[2:])


def test_ssd_wrapper_never_falls_back_off_the_cpu():
    x = torch.zeros((1, 16, 2, 16), device="meta")
    dt = torch.zeros((1, 16, 2), device="meta")
    A = torch.zeros((2,), device="meta")
    Bm = torch.zeros((1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no ssd_scan"):
        ssd_scan(x, dt, A, Bm, Bm)


def test_ssd_pad_tail_leaves_the_state_of_the_last_valid_token():
    """The model's prefill zeroes x and dt past each row's length: the
    final state is the state after the last valid token, and the valid
    rows of y are unchanged."""
    rng = np.random.default_rng(5)
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        rng, 1, 128, 4, 32, 64, "float32")
    n = 77
    xp, dp = xt.clone(), dtt.clone()
    xp[:, n:] = 0
    dp[:, n:] = 0
    y, st = ssd_scan(xp, dp, at, bt, ct, chunk=64)
    yr, sr = jax_ssd_ref(xj[:, :n], dj[:, :n], aj, bj[:, :n], cj[:, :n])
    _close_scaled(yr, y[:, :n], "float32")
    _close_scaled(sr, st, "float32")
