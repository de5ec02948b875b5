"""The port on the card: each Hopper kernel against its plain PyTorch
version, the head-sharded wrappers on a 2-rank world sharing the card,
the model's kernel path against its plain path, and served clusters
(dense llama, paged with speculation, dense Mamba2) that launch every
kernel.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.power import A100
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_verify_attention_ref,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd import ssd_ref, ssd_scan
from repro_torch.kernels.ssd import ops as sops
from repro_torch.models import model as TM
from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
from repro_torch.serving.cluster import build_predictor
from repro_torch.serving.realengine import (
    _bucket,
    make_draft_config,
    make_real_backend_factory,
)
from repro_torch.serving.request import Request
from repro_torch.serving.workload import DatasetDist, LengthDist, attach_tokens
import _mesh_worlds as W
from _mamba_weights import live_state

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18
# the SSD scan's, scale-normalised (tests/test_kernels.py:256)
SSD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build and run there")
    # plain float32 references in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,kv_len,window,softcap", [
    (16, None, None, None), (96, 70, None, None), (200, 150, 64, 50.0),
])
def test_flash_kernel_matches_plain(card, dtype, S, kv_len, window, softcap):
    g = torch.Generator(device=card).manual_seed(S)
    dt = getattr(torch, dtype)
    q = torch.randn((2, S, 8, 128), generator=g, device=card).to(dt)
    k = torch.randn((2, S, 2, 128), generator=g, device=card).to(dt)
    v = torch.randn((2, S, 2, 128), generator=g, device=card).to(dt)
    kl = None if kv_len is None else torch.tensor(
        [kv_len, 1], dtype=torch.int32, device=card)
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=kl)
    n0 = fops.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.launches == n0 + 1
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    dt = getattr(torch, dtype)
    B, C = 4, 1000  # C not a multiple of the 32-slot tile
    q = torch.randn((B, 32, 128), generator=g, device=card).to(dt)
    k = torch.randn((B, C, 8, 128), generator=g, device=card).to(dt)
    v = torch.randn((B, C, 8, 128), generator=g, device=card).to(dt)
    filled = torch.tensor([C, 500, 1, 0], device=card)  # last row empty
    slots = torch.arange(C, device=card)
    slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                           -1).to(torch.int32)
    q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
    n0 = dops.launches
    got = decode_attention(q, k, v, slot_pos, q_pos, softcap=30.0)
    torch.cuda.synchronize()
    assert dops.launches == n0 + 1
    want = decode_attention_ref(q, k, v, slot_pos, q_pos, softcap=30.0)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_drafter_shape_g1_dh16(card, dtype):
    """The drafter's shape (make_draft_config at full width): one q head
    per kv head (G = 1) and head_dim 16."""
    g = torch.Generator(device=card).manual_seed(1)
    dt = getattr(torch, dtype)
    B, C = 8, 1024
    q = torch.randn((B, 2, 16), generator=g, device=card).to(dt)
    k = torch.randn((B, C, 2, 16), generator=g, device=card).to(dt)
    v = torch.randn((B, C, 2, 16), generator=g, device=card).to(dt)
    filled = torch.tensor([C, 700, 300, 33, 17, 2, 1, 0], device=card)
    slots = torch.arange(C, device=card)
    slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                           -1).to(torch.int32)
    q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
    got = decode_attention(q, k, v, slot_pos, q_pos)
    want = decode_attention_ref(q, k, v, slot_pos, q_pos)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,q_start,window,softcap", [
    (512, [0, 256, 496], None, None), (96, [16, 0, 48], None, None),
    (40, [64, 5, 0], 32, 30.0),
])
def test_flash_q_offset_matches_plain(card, dtype, S, q_start, window,
                                      softcap):
    """Query row i at position q_start + i over the gathered view of a
    paged table (keys at 0..Skv-1), kv_len = q_start + new tokens."""
    g = torch.Generator(device=card).manual_seed(S + 7)
    dt = getattr(torch, dtype)
    B, Skv = 3, 1024
    qs = torch.tensor(q_start, dtype=torch.int32, device=card)
    new = torch.tensor([S, S // 2 + 1, 1], dtype=torch.int32, device=card)
    q = torch.randn((B, S, 32, 128), generator=g, device=card).to(dt)
    k = torch.randn((B, Skv, 8, 128), generator=g, device=card).to(dt)
    v = torch.randn((B, Skv, 8, 128), generator=g, device=card).to(dt)
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=qs + new,
              q_start=qs)
    n0, m0 = fops.launches, fops.q_offset_launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fops.launches, fops.q_offset_launches) == (n0 + 1, m0 + 1)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_q_start_zero_is_bit_exact_with_no_offset(card):
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((2, 200, 32, 128), generator=g, device=card)
    k = torch.randn((2, 200, 8, 128), generator=g, device=card)
    v = torch.randn((2, 200, 8, 128), generator=g, device=card)
    kl = torch.tensor([150, 200], dtype=torch.int32, device=card)
    zero = torch.zeros(2, dtype=torch.int32, device=card)
    a = flash_attention(q, k, v, kv_len=kl)
    b = flash_attention(q, k, v, kv_len=kl, q_start=zero)
    assert torch.equal(a, b)


# The bf16 flash path: a block holds 64 / G positions of G grouped heads
# (16 positions at G = 4), 64-key tiles on the tensor cores.
@pytest.mark.parametrize("Dh,Hq,Hkv,S,q_start,window,softcap", [
    (128, 32, 8, 200, None, None, None),  # S not a multiple of 16
    (128, 32, 8, 37, None, None, None),
    (64, 8, 2, 101, None, 48, 30.0),  # window and softcap
    (16, 2, 2, 70, None, None, None),  # the drafter's heads: G = 1
    (16, 4, 2, 512, None, 100, 50.0),
    (128, 32, 8, 512, 0, None, None),
    (128, 32, 8, 512, 256, None, None),
    (128, 32, 8, 512, 496, None, None),
    (64, 8, 2, 96, 256, 64, 30.0),
])
def test_flash_bf16_tensor_core_path_matches_plain(card, Dh, Hq, Hkv, S,
                                                  q_start, window, softcap):
    g = torch.Generator(device=card).manual_seed(S + Dh)
    B = 2
    Skv = S if q_start is None else 1024
    q = torch.randn((B, S, Hq, Dh), generator=g, device=card).bfloat16()
    k = torch.randn((B, Skv, Hkv, Dh), generator=g, device=card).bfloat16()
    v = torch.randn((B, Skv, Hkv, Dh), generator=g, device=card).bfloat16()
    qs = None if q_start is None else torch.full(
        (B,), q_start, dtype=torch.int32, device=card)
    base = 0 if q_start is None else q_start
    kl = torch.tensor([base + S, base + S // 2 + 1], dtype=torch.int32,
                      device=card)
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=kl,
              q_start=qs)
    n0 = fops.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.launches == n0 + 1
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.parametrize("Dh", [16, 64, 128])
def test_flash_bf16_row_without_keys_averages_v(card, Dh):
    """kv_len = 0: every key masked, so every query row averages V over
    all keys, as the plain version's finite -1e30 does."""
    g = torch.Generator(device=card).manual_seed(Dh)
    S, Hq, Hkv = 45, 8, 2
    q = torch.randn((2, S, Hq, Dh), generator=g, device=card).bfloat16()
    k = torch.randn((2, S, Hkv, Dh), generator=g, device=card).bfloat16()
    v = torch.randn((2, S, Hkv, Dh), generator=g, device=card).bfloat16()
    kl = torch.tensor([0, S], dtype=torch.int32, device=card)
    got = flash_attention(q, k, v, kv_len=kl)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(Hq // Hkv, dim=0)
    torch.testing.assert_close(got[0].float(), mean_v.expand(S, Hq, Dh),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    want = attention_ref(q, k, v, kv_len=kl)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def _paged_inputs(card, dtype, B, T, Hq, Hkv, Dh, ps, Pmax, lengths, seed):
    """A pool of (2B + 8) * Pmax pages plus scratch, shuffled disjoint
    tables with -1 past each row's last page."""
    g = torch.Generator(device=card).manual_seed(seed)
    dt = getattr(torch, dtype)
    P = (2 * B + 8) * Pmax + 1
    q = torch.randn((B, T, Hq, Dh), generator=g, device=card).to(dt)
    kp = torch.randn((P, ps, Hkv, Dh), generator=g, device=card).to(dt)
    vp = torch.randn((P, ps, Hkv, Dh), generator=g, device=card).to(dt)
    perm = torch.randperm(P - 1, generator=g, device=card)
    bt = torch.full((B, Pmax), -1, dtype=torch.int32, device=card)
    for b, n in enumerate(lengths):
        pages = -(-n // ps)
        bt[b, :pages] = perm[b * Pmax: b * Pmax + pages].to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    return q, kp, vp, bt, ln


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window,softcap", [
    (1, None, None), (3, None, None), (5, None, None), (3, 24, 30.0),
])
def test_paged_kernel_matches_plain(card, dtype, T, window, softcap):
    lengths = [1024, 700, 513, 512, 100, 17, T + 1, 16]
    q, kp, vp, bt, ln = _paged_inputs(card, dtype, 8, T, 32, 8, 128, 16, 64,
                                      lengths, seed=T)
    kw = dict(window=window, softcap=softcap)
    n0 = dops.paged_launches.get(T, 0)
    got = paged_verify_attention(q, kp, vp, bt, ln, **kw)
    torch.cuda.synchronize()
    assert dops.paged_launches[T] == n0 + 1
    want = paged_verify_attention_ref(q, kp, vp, bt, ln, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_paged_kernel_length_zero_row_is_zero(card):
    q, kp, vp, bt, ln = _paged_inputs(card, "bfloat16", 3, 3, 8, 2, 64, 16,
                                      4, [40, 0, 17], seed=9)
    got = paged_verify_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    want = paged_verify_attention_ref(q, kp, vp, bt, ln)
    torch.testing.assert_close(got[[0, 2]].float(), want[[0, 2]].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_t1_is_bit_exact_with_paged_decode(card, dtype):
    q, kp, vp, bt, ln = _paged_inputs(card, dtype, 8, 1, 32, 8, 128, 16, 64,
                                      [1000, 1, 16, 17, 300, 64, 65, 999],
                                      seed=4)
    ver = paged_verify_attention(q, kp, vp, bt, ln)
    dec = paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt, ln)
    assert torch.equal(ver[:, 0], dec)


# The bf16 paged path: splits of SPLIT positions (csrc/paged_attention.cu),
# then the combine pass.
_L = 128


def test_paged_bf16_scratch_holds_a_partial_per_split(card):
    """The library sizes the partials by its own split: at the main shape
    (B=8, Hkv=8, tables of 64 pages of 16) 1,024 / SPLIT splits, each
    T * G rows of (Dh accumulators, m, l); none in float32."""
    for T in (1, 3):
        assert dops._paged_scratch_floats(8, T, 32, 8, 128, 16, 64, 1) == \
            8 * 8 * (1024 // _L) * T * 4 * 130
    assert dops._paged_scratch_floats(8, 1, 32, 8, 128, 16, 64, 0) == 0


@pytest.mark.parametrize("T,lengths,window", [
    # one split less one, one split, one split and one more, page
    # boundaries, the main path's full row, and an empty slot
    (1, [_L - 1, _L, _L + 1, 144, 145, 1024, 16, 0], None),
    (3, [_L - 1, _L, _L + 1, 144, 145, 1024, 17, 0], None),
    # a window that leaves the first splits wholly masked
    (1, [600, 300, 1000, 129], 100),
    (3, [600, 300, 1000, 129], 100),
])
def test_paged_bf16_splits_match_plain(card, T, lengths, window):
    q, kp, vp, bt, ln = _paged_inputs(card, "bfloat16", len(lengths), T, 32,
                                      8, 128, 16, 64, lengths, seed=20 + T)
    got = paged_verify_attention(q, kp, vp, bt, ln, window=window)
    torch.cuda.synchronize()
    want = paged_verify_attention_ref(q, kp, vp, bt, ln, window=window)
    live = [b for b, n in enumerate(lengths) if n > 0]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    for b, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("T", [1, 3])
def test_paged_bf16_is_reproducible_and_row_independent(card, T):
    """No float atomics and splits fixed in positions: two identical
    calls agree bitwise, and a row computed alone equals the same row
    inside a batch of 8."""
    lengths = [1000, 1, 16, 17, 300, 64, 65, 0]
    q, kp, vp, bt, ln = _paged_inputs(card, "bfloat16", 8, T, 32, 8, 128,
                                      16, 64, lengths, seed=30 + T)
    a = paged_verify_attention(q, kp, vp, bt, ln)
    b = paged_verify_attention(q, kp, vp, bt, ln)
    assert torch.equal(a, b)
    for row in (0, 4):
        alone = paged_verify_attention(
            q[row:row + 1].contiguous(), kp, vp, bt[row:row + 1].contiguous(),
            ln[row:row + 1].contiguous())
        assert torch.equal(alone[0], a[row])


def test_paged_matches_ring_decode_on_the_same_cache(card):
    """tests/test_kernels.py:194: the paged and ring layouts are two views
    of one cache."""
    g = torch.Generator(device=card).manual_seed(5)
    ps, n_pages, C = 16, 8, 128
    q = torch.randn((1, 8, 64), generator=g, device=card)
    k = torch.randn((1, C, 2, 64), generator=g, device=card)
    v = torch.randn((1, C, 2, 64), generator=g, device=card)
    L = 77
    slot_pos = torch.where(torch.arange(C, device=card) < L,
                           torch.arange(C, device=card), -1)[None]
    ring = decode_attention(q, k, v, slot_pos.to(torch.int32),
                            torch.tensor([L - 1], dtype=torch.int32,
                                         device=card))
    bt = torch.arange(n_pages, dtype=torch.int32, device=card)[None]
    paged = paged_decode_attention(
        q, k.reshape(n_pages, ps, 2, 64), v.reshape(n_pages, ps, 2, 64), bt,
        torch.tensor([L], dtype=torch.int32, device=card))
    torch.testing.assert_close(paged, ring, atol=2e-5, rtol=2e-5)


# The bf16 ring path: runs of SPLIT ring slots (csrc/ring_decode.cu), a run
# with no valid slot skipped unless its whole row has none, then the
# combine pass.
_RUN = 128


def _ring_inputs(card, rows, C, Hq, Hkv, Dh, seed):
    """bf16 q, K and V and the ring's slot positions, one row per entry of
    ``rows``: ("fill", n) is the main path's identity layout (slot i holds
    position i for i < n, the rest empty; q at n - 1, n = 0 an empty row);
    ("wrap", n) a ring that has wrapped, slot c holding the last position
    p < n with p = c mod C (q at n - 1); ("future", n) every slot holding
    a position after q's n, so that none is valid."""
    g = torch.Generator(device=card).manual_seed(seed)
    B = len(rows)
    q = torch.randn((B, Hq, Dh), generator=g, device=card).bfloat16()
    k = torch.randn((B, C, Hkv, Dh), generator=g, device=card).bfloat16()
    v = torch.randn((B, C, Hkv, Dh), generator=g, device=card).bfloat16()
    c = torch.arange(C, device=card)
    pos, qpos = [], []
    for kind, n in rows:
        if kind == "fill":
            pos.append(torch.where(c < n, c, -1))
            qpos.append(max(n - 1, 0))
        elif kind == "wrap":
            last = n - 1 - torch.remainder(n - 1 - c, C)
            pos.append(torch.where(last >= 0, last, -1))
            qpos.append(n - 1)
        else:
            pos.append(c + n + 1)
            qpos.append(n)
    slot_pos = torch.stack(pos).to(torch.int32)
    q_pos = torch.tensor(qpos, dtype=torch.int32, device=card)
    return q, k, v, slot_pos, q_pos


def _mean_of_v(v, row, G):
    """A row with no valid slot: the mean of V over every slot, per q head."""
    return v[row].float().mean(dim=0).repeat_interleave(G, dim=0)


@pytest.mark.parametrize("C,rows,window,softcap", [
    # valid slots ending one before, at and one after a run boundary, at
    # the next one, the main path's full row, one slot, an empty slot
    (1024, [("fill", _RUN - 1), ("fill", _RUN), ("fill", _RUN + 1),
            ("fill", 2 * _RUN), ("fill", 2 * _RUN - 1), ("fill", 1024),
            ("fill", 1), ("fill", 0)], None, None),
    (1024, [("fill", _RUN - 1), ("fill", _RUN), ("fill", _RUN + 1),
            ("fill", 700), ("fill", 0)], None, 30.0),
    # wrapped rings: positions out of slot order, every slot written, or
    # written part of the way round; a row whose slots all lie ahead of q
    (512, [("wrap", 600), ("wrap", 513), ("wrap", 1000), ("wrap", 300),
           ("fill", 0), ("future", 10)], None, None),
    # a window of 100 leaves whole runs empty in rows that have valid
    # slots: 600 keeps slots 0..87 and 500..511 (runs 0 and 3), 1000
    # slots 388..487 (run 3), the identity row 300 slots 200..299
    (512, [("wrap", 600), ("wrap", 513), ("wrap", 1000), ("fill", 300),
           ("fill", 0)], 100, None),
])
def test_ring_bf16_runs_match_plain(card, C, rows, window, softcap):
    q, k, v, sp, qp = _ring_inputs(card, rows, C, 32, 8, 128, seed=C + len(rows))
    kw = dict(window=window, softcap=softcap)
    n0 = dops.launches
    got = decode_attention(q, k, v, sp, qp, **kw)
    torch.cuda.synchronize()
    assert dops.launches == n0 + 1  # split + combine count once
    want = decode_attention_ref(q, k, v, sp, qp, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
    for row, (kind, n) in enumerate(rows):
        if (kind, n) == ("fill", 0) or kind == "future":
            torch.testing.assert_close(got[row].float(), _mean_of_v(v, row, 4),
                                       atol=TOL["bfloat16"],
                                       rtol=TOL["bfloat16"])


@pytest.mark.parametrize("Dh", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 12, 32])
def test_ring_bf16_head_shapes_match_plain(card, G, Dh):
    """G grouped heads a kv head (3 and 12 are not powers of two; 32 takes
    two row fragments) at every head dim, over a ring of 1000 slots (not
    a whole number of runs) with an empty row."""
    Hkv = 2
    rows = [("fill", 1000), ("fill", _RUN + 1), ("fill", 0), ("wrap", 1500)]
    q, k, v, sp, qp = _ring_inputs(card, rows, 1000, G * Hkv, Hkv, Dh,
                                   seed=G * 1000 + Dh)
    got = decode_attention(q, k, v, sp, qp)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, sp, qp)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
    torch.testing.assert_close(got[2].float(), _mean_of_v(v, 2, G),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def test_ring_bf16_tp2_shard_shape(card):
    """One rank's shard at tp=2 (Hq=16, Hkv=4: G=2), the main path's rows."""
    rows = [("fill", n) for n in (1024, 700, 513, 512, 300, 129, 74, 0)]
    q, k, v, sp, qp = _ring_inputs(card, rows, 1024, 16, 4, 128, seed=16)
    got = decode_attention(q, k, v, sp, qp)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, sp, qp)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def test_ring_bf16_is_reproducible_and_row_independent(card):
    """No float atomics and runs fixed in slots: two identical calls agree
    bitwise, and a row computed alone equals the same row inside a batch
    of 8."""
    rows = [("fill", 1000), ("fill", 1), ("wrap", 1300), ("fill", 129),
            ("fill", 300), ("fill", 0), ("future", 5), ("fill", 512)]
    q, k, v, sp, qp = _ring_inputs(card, rows, 1024, 32, 8, 128, seed=31)
    a = decode_attention(q, k, v, sp, qp)
    b = decode_attention(q, k, v, sp, qp)
    assert torch.equal(a, b)
    for row in (0, 2, 5):
        alone = decode_attention(
            q[row:row + 1].contiguous(), k[row:row + 1].contiguous(),
            v[row:row + 1].contiguous(), sp[row:row + 1].contiguous(),
            qp[row:row + 1].contiguous())
        assert torch.equal(alone[0], a[row])


def test_ring_bf16_scratch_holds_a_partial_per_run(card):
    """The library sizes the partials by its own runs: at the main shape
    (B=8, C=1024, Hq=32, Hkv=8, Dh=128) 1,024 / SPLIT runs, each G rows
    of (Dh accumulators, m, l); none in float32."""
    assert dops._ring_scratch_floats(8, 1024, 32, 8, 128, 1) == \
        8 * 8 * (1024 // _RUN) * 4 * 130
    assert dops._ring_scratch_floats(8, 1000, 32, 8, 128, 1) == \
        8 * 8 * 8 * 4 * 130
    assert dops._ring_scratch_floats(8, 1024, 32, 8, 128, 0) == 0


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.zeros((1, 16, 4, 48), device=card)  # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 16, 4, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros((1, 16, 4, 64), device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)


def test_sharded_wrappers_two_ranks_on_one_card(card, tmp_path):
    """The head-sharded wrappers (repro/kernels/decode_attention/ops.py:
    48, 86, 122) on a 2-rank world that shares the card (gloo): at the
    main shapes each rank launches its kernel once a call on 4 of the 8
    kv heads, by DTensors and by the model's local-heads route, and the
    gathered output matches the plain version on the full tensors, in
    bf16 and float32.  An empty batch launches nothing and counts
    nothing."""
    from repro_torch.kernels import _build

    _build.build(["ring_decode", "paged_attention"])  # once, not per rank
    ranks = W.start_world(W.card_wrapper_rank, 2, tmp_path,
                          device_type="cuda").result()
    for rank, res in enumerate(ranks):
        assert res.pop("empty") == {}, rank
        assert set(res) == {"decode", "paged_decode", "paged_verify"}
        for kind, by_dtype in res.items():
            for dtype, by_route in by_dtype.items():
                assert set(by_route) == set(W.ROUTES)
                for route, (err, ok, launched) in by_route.items():
                    assert ok, (rank, kind, dtype, route, err)
                    assert launched == {4: 1}, (rank, kind, dtype, route,
                                                launched)
    assert ranks[0] == ranks[1]  # both hold the same gathered output


def test_model_kernel_path_matches_plain_path(card):
    """Reduced llama in float32 on the card: prefill and 8 decode steps
    through the kernels agree with the plain-attention path."""
    cfg = dataclasses.replace(REGISTRY["llama-3.1-8b"].reduced(),
                              dtype="float32")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    lengths = torch.tensor([48, 30], dtype=torch.int32, device=card)
    lk, ck = TM.prefill(params, cfg, toks, lengths, max_len=64)
    lp, cp = TM.prefill(params, cfg, toks, lengths, max_len=64,
                        plain_attention=True)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    tok, pos = lk.argmax(-1).to(torch.int32), lengths.clone()
    for _ in range(8):
        lk, ck = TM.decode_step(params, cfg, tok, ck, pos)
        lp, cp = TM.decode_step(params, cfg, tok, cp, pos,
                                plain_attention=True)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        tok, pos = lk.argmax(-1).to(torch.int32), pos + 1


def test_served_cluster_launches_both_kernels(card):
    base = REGISTRY["llama-3.1-8b"]
    cfg = dataclasses.replace(base.reduced(), dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    reqs = attach_tokens(poisson_workload(
        DatasetDist("tiny", LengthDist(24.0, 10.0, hi=60),
                    LengthDist(6.0, 3.0, hi=12)), 2.0, 4.0, seed=3),
        cfg.vocab_size, seed=4)
    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000)
    fops.launches = dops.launches = 0
    m = PDCluster(ClusterConfig(
        model=base, chip=A100, n_prefill=1, n_decode=2, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=2,
        backend_factory=make_real_backend_factory(cfg, params, slots=8,
                                                  max_len=128),
    )).run(reqs)
    assert m.finished_frac() == 1.0
    assert fops.launches > 0 and dops.launches > 0
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1


def _multiturn(vocab, n_convs=2, n_turns=3, system_len=48):
    """Turns that each extend the last, after a shared system prompt."""
    g = torch.Generator().manual_seed(11)
    system = torch.randint(0, vocab, (system_len,), generator=g).tolist()
    hist = {c: list(system) for c in range(n_convs)}
    reqs, rid = [], 0
    for turn in range(n_turns):
        for c in range(n_convs):
            prompt = hist[c] + torch.randint(0, vocab, (8,),
                                             generator=g).tolist()
            r = Request(rid, 2.0 * turn + 0.3 * c, prompt_len=len(prompt),
                        decode_len=6, conv_id=c, turn=turn)
            r.prompt_tokens = list(prompt)
            reqs.append(r)
            rid += 1
            hist[c] = prompt + [0] * 6
    return reqs


def test_served_paged_and_spec_clusters_launch_their_kernels(card):
    """Reduced llama in bf16: a paged cluster with a radix prefix cache
    launches paged decode (T = 1) and the q-offset prefill; a paged +
    speculative one launches the verify pass at T = k + 1 = 3."""
    base = REGISTRY["llama-3.1-8b"]
    cfg = dataclasses.replace(base.reduced(), dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    dcfg = make_draft_config(cfg)
    dparams = TM.init_params(dcfg,
                             torch.Generator(device=card).manual_seed(1),
                             device=card)
    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=2)
    for spec_k in (0, 2):
        reqs = _multiturn(cfg.vocab_size)
        fops.launches = fops.q_offset_launches = 0
        dops.paged_launches.clear()
        cl = PDCluster(ClusterConfig(
            model=base, chip=A100, n_prefill=1, n_decode=1,
            policy="voltana", predictor=pred, kv_capacity_tokens=400_000,
            online_adapt=False, decode_max_running=8, seed=2,
            prefill_chunk_tokens=64, prefix_cache=True,
            prefix_cache_capacity=2_048, paged=True, kv_page_size=16,
            spec_decode=spec_k > 0, spec_k=max(spec_k, 1),
            backend_factory=make_real_backend_factory(
                cfg, params, slots=8, max_len=128, paged=True, page_size=16,
                pool_pages=256, spec_k=spec_k, draft_cfg=dcfg,
                draft_params=dparams),
        ))
        m = cl.run(reqs)
        assert m.finished_frac() == 1.0
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
            assert all(0 <= t < cfg.vocab_size for t in r.output_tokens)
        assert cl.prefill[0].backend.reused_tokens > 0
        assert fops.q_offset_launches > 0
        cl.decode[0].backend.pool.assert_empty()
        if spec_k:
            assert m.spec_iterations() > 0
            assert dops.paged_launches.get(3, 0) > 0
        else:
            assert dops.paged_launches.get(1, 0) > 0


# ---------------------------------------------------------------------------
# SSD chunked scan and the Mamba2 model
# ---------------------------------------------------------------------------


def _ssd_inputs(card, dtype, B, S, H, P, N, seed, law=False):
    """tests/test_kernels.py:244-249 on the card: x, B and C in the
    working dtype, dt post-softplus and A negative in float32 (about 0.7
    and -1: a memory of about 2 tokens), or with ``law`` drawn as the
    model draws them (``_model_law``)."""
    g = torch.Generator(device=card).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    x = torch.randn((B, S, H, P), generator=g, device=card).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=card))
    A = -torch.exp(torch.randn((H,), generator=g, device=card) * 0.3)
    Bm = (torch.randn((B, S, N), generator=g, device=card) * 0.3).to(dt_)
    Cm = (torch.randn((B, S, N), generator=g, device=card) * 0.3).to(dt_)
    if law:
        dt, A = _model_law(card, g, B, S, H)
    return x, dt, A, Bm, Cm


def _model_law(card, g, B, S, H):
    """dt and A drawn as the model makes them (``init_params``'s law):
    dt = softplus(dt_raw + dt_bias) with softplus(dt_bias) log-uniform in
    [1e-3, 0.1], and -A uniform in [1, 16].  The state then remembers up
    to about 1000 tokens, across every sub-chunk and chunk boundary."""
    u = torch.rand((H,), generator=g, device=card)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt_raw = 0.1 * torch.randn((B, S, H), generator=g, device=card)
    dt = torch.nn.functional.softplus(dt_raw + dt_bias)
    A = -(1.0 + 15.0 * torch.rand((H,), generator=g, device=card))
    return dt, A


def _ssd_close(got, want, dtype):
    scale = float(want.float().abs().max()) + 1e-9
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= SSD_TOL[dtype], f"scale-normalised error {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,law", [
    (2, 256, 4, 64, 128, 64, False),
    (1, 512, 8, 32, 64, 128, False),
    (2, 128, 2, 64, 32, 128, False),
    (1, 96, 4, 16, 16, 32, False),  # the reduced config's head, state dims
    (1, 512, 80, 64, 128, 256, False),  # mamba2-2.7b's prefill at S=512
    # the same with the model's dt and A: the carry crosses every
    # sub-chunk and chunk, so a fault there shows in y and the state
    (1, 512, 80, 64, 128, 256, True),
])
def test_ssd_kernel_matches_plain(card, dtype, B, S, H, P, N, chunk, law):
    x, dt, A, Bm, Cm = _ssd_inputs(card, dtype, B, S, H, P, N, seed=S + N,
                                   law=law)
    n0 = sops.launches
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert sops.launches == n0 + 1
    assert y.dtype == x.dtype and st.dtype == torch.float32
    yr, sr = ssd_ref(x, dt, A, Bm, Cm)
    _ssd_close(y, yr, dtype)
    _ssd_close(st, sr, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_reads_model_slices_and_pad_tails(card, dtype):
    """x, B and C as slices of one (B, S, conv_dim) tensor, as the model
    passes them, with x = dt = 0 past each row's length: the final state
    is the state after the last valid token."""
    Bsz, S, H, P, N = 2, 192, 4, 32, 64
    g = torch.Generator(device=card).manual_seed(7)
    di = H * P
    xbc = torch.randn((Bsz, S, di + 2 * N), generator=g,
                      device=card).to(getattr(torch, dtype))
    lengths = torch.tensor([S, 77], device=card)
    valid = torch.arange(S, device=card)[None] < lengths[:, None]
    xbc = xbc * valid[..., None].to(xbc.dtype)
    xs = xbc[..., :di].reshape(Bsz, S, H, P)
    Bm, Cm = xbc[..., di: di + N] * 0.3, xbc[..., di + N:] * 0.3
    dt = torch.nn.functional.softplus(
        torch.randn((Bsz, S, H), generator=g, device=card)) * valid[..., None]
    A = -torch.exp(torch.randn((H,), generator=g, device=card) * 0.3)
    y, st = ssd_scan(xs, dt, A, Bm, Cm, chunk=64)
    yr, sr = ssd_ref(xs, dt, A, Bm, Cm)
    _ssd_close(y, yr, dtype)
    _ssd_close(st, sr, dtype)
    n = 77
    _, s_short = ssd_ref(xs[1:, :n], dt[1:, :n], A, Bm[1:, :n], Cm[1:, :n])
    _ssd_close(st[1:], s_short, dtype)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, dt, A, Bm, Cm = _ssd_inputs(card, "float32", 1, 64, 2, 24, 16, 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_scan(x, dt, A, Bm, Cm)
    x, dt, A, Bm, Cm = _ssd_inputs(card, "float32", 1, 64, 2, 16, 48, 0)
    with pytest.raises(ValueError, match="state dim"):
        ssd_scan(x, dt, A, Bm, Cm)
    x, dt, A, Bm, Cm = _ssd_inputs(card, "float32", 1, 64, 2, 16, 16, 0)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x, dt.to(torch.bfloat16), A, Bm, Cm)
    with pytest.raises(ValueError, match="chunk must divide"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=48)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_is_reproducible_and_row_independent(card, dtype):
    """No float atomics, and no state shared between batch rows (the bf16
    C.B^T pre-pass is per row): two identical calls agree bitwise, and
    row 1 of a B=2 call equals a B=1 call on that row."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, dtype, 2, 320, 8, 64, 128, seed=41,
                                   law=True)
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    y2, st2 = ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y1, st1 = ssd_scan(x[1:].contiguous(), dt[1:].contiguous(), A,
                       Bm[1:].contiguous(), Cm[1:].contiguous(), chunk=64)
    assert torch.equal(y1[0], y[1]) and torch.equal(st1[0], st[1])


def test_ssd_bf16_scratch_holds_c_bt_per_sub_chunk(card):
    """The library sizes the C.B^T scratch by its own 64-row sub-chunks:
    one 64 x 64 float32 tile per (batch row, sub-chunk); none in
    float32."""
    assert sops._cb_scratch_floats(1, 512, 1) == 8 * 64 * 64
    assert sops._cb_scratch_floats(2, 100, 1) == 2 * 2 * 64 * 64
    assert sops._cb_scratch_floats(1, 512, 0) == 0


def test_ssd_bf16_rejects_unaligned_rows(card):
    """The bf16 scan copies x, B and C in 16-byte pieces: a B that starts
    mid-piece is refused, not read misaligned."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, "bfloat16", 1, 64, 2, 16, 16, 0)
    wide = torch.zeros((1, 64, 17), dtype=torch.bfloat16, device=card)
    wide[..., 1:] = Bm
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan(x, dt, A, wide[..., 1:], Cm)


def test_mamba_model_kernel_path_matches_plain_path(card):
    """Reduced mamba2 in float32 on the card, with weights under which the
    state reaches the logits (``live_state``): prefill through the
    ssd_scan kernel agrees with the plain ``L.ssd_chunked`` path, in
    logits and in the recurrent cache (scale-normalised), then 8 decode
    steps agree."""
    cfg = dataclasses.replace(REGISTRY["mamba2-2.7b"].reduced(),
                              dtype="float32")
    params = live_state(TM.init_params(
        cfg, torch.Generator(device=card).manual_seed(0), device=card), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    lengths = torch.tensor([64, 30], dtype=torch.int32, device=card)
    n0 = sops.launches
    lk, ck = TM.prefill(params, cfg, toks, lengths, max_len=128)
    assert sops.launches == n0 + cfg.n_blocks
    lp, cp = TM.prefill(params, cfg, toks, lengths, max_len=128,
                        plain_attention=True)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    for key in ("ssm", "conv"):
        assert float(cp["layer_0"][key].abs().max()) > 0.1, key
        _ssd_close(ck["layer_0"][key], cp["layer_0"][key], "float32")
    tok, pos = lk.argmax(-1).to(torch.int32), lengths.clone()
    for _ in range(8):
        lk, ck = TM.decode_step(params, cfg, tok, ck, pos)
        lp, cp = TM.decode_step(params, cfg, tok, cp, pos,
                                plain_attention=True)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        tok, pos = lk.argmax(-1).to(torch.int32), pos + 1


def test_served_mamba_cluster_launches_ssd_scan_and_replays(card):
    """Reduced mamba2 in bf16 through the dense P/D cluster: ssd_scan
    launches once per block per real prefill, no attention kernel runs,
    and each stream replays through the plain path within 0.05 of its
    max logit (the reduced model's margin in the CPU tests).  The weights
    are ``live_state``'s, so the replay sees the handed-over state."""
    base = REGISTRY["mamba2-2.7b"]
    cfg = dataclasses.replace(base.reduced(), dtype="bfloat16")
    params = live_state(TM.init_params(
        cfg, torch.Generator(device=card).manual_seed(0), device=card), cfg)
    reqs = attach_tokens(poisson_workload(
        DatasetDist("tiny", LengthDist(24.0, 10.0, hi=60),
                    LengthDist(6.0, 3.0, hi=12)), 2.0, 4.0, seed=3),
        cfg.vocab_size, seed=4)
    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000)
    prefills = []
    base_factory = make_real_backend_factory(cfg, params, slots=8,
                                             max_len=128)

    def factory(kind, idx, hw, seed, tp=None):
        be = base_factory(kind, idx, hw, seed, tp=tp)
        inner = be._real_prefill

        def counted(r):
            prefills.append(r.rid)
            return inner(r)

        be._real_prefill = counted
        return be

    fops.launches = dops.launches = sops.launches = 0
    dops.paged_launches.clear()
    m = PDCluster(ClusterConfig(
        model=base, chip=A100, n_prefill=1, n_decode=2, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=2, backend_factory=factory,
    )).run(reqs)
    assert m.finished_frac() == 1.0
    assert sops.launches == cfg.n_blocks * len(prefills) > 0
    assert fops.launches == dops.launches == 0 and not dops.paged_launches
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1
        assert all(0 <= t < cfg.vocab_size for t in r.output_tokens)
    for r in reqs[:4]:
        n = len(r.prompt_tokens)
        buf = torch.zeros((1, _bucket(n, hi=128)), dtype=torch.int32,
                          device=card)
        buf[0, :n] = torch.tensor(r.prompt_tokens, device=card)
        logits, cache = TM.prefill(
            params, cfg, buf, torch.tensor([n], device=card), max_len=128,
            plain_attention=True)
        pos = torch.tensor([n], device=card)
        for i, tok in enumerate(r.output_tokens):
            row = logits[0].double()
            assert float(row.max() - row[tok]) <= 0.05, (r.rid, i)
            logits, cache = TM.decode_step(
                params, cfg, torch.tensor([tok], device=card), cache, pos,
                plain_attention=True)
            pos = pos + 1


# ---------------------------------------------------------------------------
# Step graphs (serving/jitcache.StepGraph) and the LM head
# ---------------------------------------------------------------------------


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def _tree_equal(a, b):
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _ptrs(tree):
    if isinstance(tree, dict):
        return {k: _ptrs(v) for k, v in tree.items()}
    return tree.data_ptr()


def _graph_vs_eager(entry, params, cache, inputs, chain=None):
    """Run ``entry`` over ``inputs`` (one dict of tensors a step) eagerly on
    one copy of ``cache`` and through a :class:`StepGraph` on another:
    every step's outputs and the caches must be bitwise equal, the graph's
    cache and params must stay where they were, and the launch counters
    must tick alike.  ``chain`` feeds a step's first output to the next
    step's ``tokens``.  Returns the graph's launch counts of the run."""
    from repro_torch import kernels
    from repro_torch.serving import jitcache

    ca, cb = _tree_clone(cache), _tree_clone(cache)
    ptrs, pptrs = _ptrs(cb), _ptrs(params)
    runs = {}
    for side, c in (("eager", ca), ("graph", cb)):
        graph = jitcache.StepGraph(torch.device("cuda"))
        call = entry if side == "eager" else (
            lambda *a, **k: graph(entry, *a, **k))
        before = kernels.launch_counts()
        captures = jitcache.capture_count()
        outs, tok = [], None
        for inp in inputs:
            if chain and tok is not None:
                inp = dict(inp, tokens=tok)
            out = call(params, cache=c, **inp)
            outs.append([o.clone() for o in out if torch.is_tensor(o)])
            tok = out[0]
        torch.cuda.synchronize()
        runs[side] = (outs, kernels.launches_since(before),
                      jitcache.capture_count() - captures)
    (eo, el, ec), (go, gl, gc_) = runs["eager"], runs["graph"]
    for i, (e, g) in enumerate(zip(eo, go)):
        assert all(torch.equal(x, y) for x, y in zip(e, g)), f"step {i}"
    assert _tree_equal(ca, cb)
    assert _ptrs(cb) == ptrs and _ptrs(params) == pptrs
    assert el == gl
    assert (ec, gc_) == (0, 1)
    return gl


def _reduced(arch, dtype):
    cfg = dataclasses.replace(REGISTRY[arch].reduced(), dtype=dtype)
    params = TM.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    return cfg, params


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("paged", [False, True])
def test_graph_replay_equals_eager_decode(card, dtype, paged):
    """Reduced llama: 16 decode steps replayed from a CUDA graph equal
    16 eager steps bit for bit, in ids and cache, dense and paged; the
    counters count one ring or paged launch a layer a step."""
    from functools import partial

    cfg, params = _reduced("llama-3.1-8b", dtype)
    B, steps = 8, 16
    g = torch.Generator(device=card).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, 48), device=card,
                         generator=g, dtype=torch.int32)
    lengths = torch.tensor([48, 30, 17, 48, 5, 40, 1, 33], dtype=torch.int32,
                           device=card)
    if not paged:
        _, cache = TM.prefill(params, cfg, toks, lengths, max_len=128)
        entry = partial(TM.decode_step_greedy, cfg=cfg)
        extra = {}
    else:
        ps, pmax = 16, 8
        cache = TM.init_paged_cache(cfg, B * pmax, ps, card)
        for e in cache.values():
            for t in e.values():
                t.copy_(torch.randn(t.shape, device=card, generator=g))
        bt = torch.arange(B * pmax, dtype=torch.int32,
                          device=card).reshape(B, pmax)
        entry = partial(TM.decode_step_paged_greedy, cfg=cfg)
        extra = dict(block_tables=bt)
    inputs = [dict(tokens=toks[:, 0], lengths=lengths + i, **extra)
              for i in range(steps)]
    counts = _graph_vs_eager(entry, params, cache, inputs, chain=True)
    key = (("decode_attention", "paged_launches", 1) if paged
           else ("decode_attention", "launches"))
    assert counts == {key: cfg.n_layers * steps}


def test_graph_replay_equals_eager_draft_and_verify(card):
    """Reduced llama in bf16: the drafter's step (ring at Dh=16) and the
    verify pass (paged at T=3) replay bitwise as eager."""
    from functools import partial

    cfg, params = _reduced("llama-3.1-8b", "bfloat16")
    dcfg = make_draft_config(cfg)
    dparams = TM.init_params(dcfg,
                             torch.Generator(device=card).manual_seed(1),
                             device=card)
    B = 8
    g = torch.Generator(device=card).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (B, 32), device=card,
                         generator=g, dtype=torch.int32)
    lengths = torch.full((B,), 32, dtype=torch.int32, device=card)
    _, dcache = TM.prefill(dparams, dcfg, toks, lengths, max_len=128)
    counts = _graph_vs_eager(
        partial(TM.draft_step, cfg=dcfg), dparams, dcache,
        [dict(tokens=toks[:, 0], lengths=lengths + i) for i in range(6)],
        chain=True)
    assert counts == {("decode_attention", "launches"): dcfg.n_layers * 6}
    ps, pmax = 16, 8
    pool = TM.init_paged_cache(cfg, B * pmax, ps, card)
    for e in pool.values():
        for t in e.values():
            t.copy_(torch.randn(t.shape, device=card, generator=g))
    bt = torch.arange(B * pmax, dtype=torch.int32,
                      device=card).reshape(B, pmax)
    inputs = [dict(tokens=torch.randint(0, cfg.vocab_size, (B, 3),
                                        device=card, generator=g,
                                        dtype=torch.int32),
                   lengths=lengths + 3 * i, block_tables=bt)
              for i in range(6)]
    counts = _graph_vs_eager(partial(TM.verify_step_paged_greedy, cfg=cfg),
                             params, pool, inputs)
    assert counts == {("decode_attention", "paged_launches", 3):
                      cfg.n_layers * 6}


def test_graph_replay_equals_eager_mamba_decode(card):
    """Reduced mamba2 with ``live_state`` weights: 16 decode steps from a
    graph equal eager ones in ids, SSM state and conv tail, bit for bit
    (the step is not idempotent, so a capture that ran it would show)."""
    from functools import partial

    cfg, params = _reduced("mamba2-2.7b", "bfloat16")
    params = live_state(params, cfg)
    g = torch.Generator(device=card).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (8, 64), device=card,
                         generator=g, dtype=torch.int32)
    lengths = torch.tensor([64, 30, 17, 64, 5, 40, 1, 33], dtype=torch.int32,
                           device=card)
    _, cache = TM.prefill(params, cfg, toks, lengths, max_len=128)
    assert float(cache["layer_0"]["ssm"].abs().max()) > 0.1
    counts = _graph_vs_eager(
        partial(TM.decode_step_greedy, cfg=cfg), params, cache,
        [dict(tokens=toks[:, 0], lengths=lengths + i) for i in range(16)],
        chain=True)
    assert counts == {}  # the Mamba2 step launches no kernel of ours


@pytest.mark.parametrize("kind", ["dense", "paged", "spec", "mamba"])
def test_served_graphs_equal_eager_streams(card, kind):
    """The same workload through a cluster whose decode instances replay
    graphs (the default on the card) and one with ``cuda_graphs=False``:
    equal streams, one capture per decode backend and entry it used, and
    the same first-seen shapes."""
    from repro_torch.serving import jitcache

    arch = "mamba2-2.7b" if kind == "mamba" else "llama-3.1-8b"
    base = REGISTRY[arch]
    cfg, params = _reduced(arch, "bfloat16")
    kw, ckw = {}, {}
    if kind != "dense" and kind != "mamba":
        kw = dict(paged=True, page_size=16, pool_pages=256)
        ckw = dict(paged=True, kv_page_size=16, prefix_cache=True,
                   prefix_cache_capacity=2_048)
    if kind == "spec":
        dcfg = make_draft_config(cfg)
        kw.update(spec_k=2, draft_cfg=dcfg, draft_params=TM.init_params(
            dcfg, torch.Generator(device=card).manual_seed(1), device=card))
        ckw.update(spec_decode=True, spec_k=2)
    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=2 if kind == "spec" else 0)
    runs = {}
    for graphs in (None, False):
        jitcache.clear()
        reqs = (_multiturn(cfg.vocab_size) if kw.get("paged") else
                attach_tokens(poisson_workload(
                    DatasetDist("tiny", LengthDist(24.0, 10.0, hi=60),
                                LengthDist(6.0, 3.0, hi=12)), 2.0, 4.0,
                    seed=3), cfg.vocab_size, seed=4))
        cl = PDCluster(ClusterConfig(
            model=base, chip=A100, n_prefill=1, n_decode=2,
            policy="voltana", predictor=pred, kv_capacity_tokens=400_000,
            online_adapt=False, decode_max_running=8, seed=2,
            prefill_chunk_tokens=64, **ckw,
            backend_factory=make_real_backend_factory(
                cfg, params, slots=8, max_len=128, cuda_graphs=graphs,
                **kw)))
        m = cl.run(reqs)
        assert m.finished_frac() == 1.0
        used = sum(e.backend.pipeline_dispatches > 0 for e in cl.decode)
        runs[graphs] = ([r.output_tokens for r in reqs],
                        jitcache.compile_count(), jitcache.capture_count(),
                        jitcache.replay_count(), used)
    (gs, gcomp, gcap, grep, used), (es, ecomp, ecap, _, _) = \
        runs[None], runs[False]
    assert gs == es
    assert gcomp == ecomp and ecap == 0
    assert gcap == used * (2 if kind == "spec" else 1) > 0
    assert grep > 0


def test_lm_head_multiplies_bf16_into_float32_without_a_float32_head(card):
    """On the card a bf16 head takes bf16 operands into float32 logits
    (``aten::mm.dtype``): close to the float32 upcast, also for tied
    embeddings, and no float32 copy of the head is made."""
    cfg = dataclasses.replace(REGISTRY["llama-3.1-8b"].reduced(),
                              dtype="bfloat16", vocab_size=32_000)
    g = torch.Generator(device=card).manual_seed(6)
    head = (torch.randn((cfg.d_model, cfg.vocab_size), generator=g,
                        device=card) * 0.02).to(torch.bfloat16)
    h = torch.randn((3, 2, cfg.d_model), generator=g,
                    device=card).to(torch.bfloat16)
    for tied, params in ((False, {"lm_head": head}),
                         (True, {"embed": head.T.contiguous()})):
        c = dataclasses.replace(cfg, tie_embeddings=tied)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = TM.lm_logits(params, c, h)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        assert got.dtype == torch.float32 and got.shape == (3, 2,
                                                            cfg.vocab_size)
        torch.testing.assert_close(got, h.float() @ head.float(),
                                   atol=2e-2, rtol=2e-2)
        assert extra < head.numel() * 2, (tied, extra)


# ---------------------------------------------------------------------------
# The dense family's head shapes and vocabularies: ministral-3b and
# phi4-mini (G = 3), qwen3-32b and chameleon-34b (G = 8), command-r-plus
# (G = 12), minicpm-2b (MHA at head dim 64)
# ---------------------------------------------------------------------------

DENSE_HEADS = [  # (Dh, Hq, Hkv)
    pytest.param(128, 24, 8, id="G3"), pytest.param(128, 64, 8, id="G8"),
    pytest.param(128, 96, 8, id="G12"), pytest.param(64, 36, 36, id="Dh64-G1"),
]


@pytest.mark.parametrize("q_start", [None, 256], ids=["prompt", "q_offset"])
@pytest.mark.parametrize("Dh,Hq,Hkv", DENSE_HEADS)
def test_flash_bf16_dense_family_heads_match_plain(card, Dh, Hq, Hkv,
                                                   q_start):
    """A bf16 flash block holds 64 // G positions of G heads: 21 at G = 3
    (63 rows), 8 at G = 8, 5 at G = 12 (60 rows), 64 at G = 1; with and
    without a query offset over a 1024-key view."""
    g = torch.Generator(device=card).manual_seed(Hq + Dh)
    B, S = 2, 300
    Skv = S if q_start is None else 1024
    q = torch.randn((B, S, Hq, Dh), generator=g, device=card).bfloat16()
    k = torch.randn((B, Skv, Hkv, Dh), generator=g, device=card).bfloat16()
    v = torch.randn((B, Skv, Hkv, Dh), generator=g, device=card).bfloat16()
    base = 0 if q_start is None else q_start
    qs = None if q_start is None else torch.tensor(
        [q_start, 100], dtype=torch.int32, device=card)
    kl = torch.tensor([base + S, S // 2 + 1 + (0 if q_start is None else 100)],
                      dtype=torch.int32, device=card)
    kw = dict(causal=True, kv_len=kl, q_start=qs)
    n0 = fops.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.launches == n0 + 1
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.parametrize("Dh,Hq,Hkv", DENSE_HEADS)
def test_ring_bf16_dense_family_heads_match_plain(card, Dh, Hq, Hkv):
    """The main path's ring (8 slots of 1024) at the family's groups."""
    rows = [("fill", n) for n in (1024, 700, 513, 512, 300, 129, 74, 0)]
    q, k, v, sp, qp = _ring_inputs(card, rows, 1024, Hq, Hkv, Dh,
                                   seed=Hq * 7 + Dh)
    n0 = dops.launches
    got = decode_attention(q, k, v, sp, qp)
    torch.cuda.synchronize()
    assert dops.launches == n0 + 1
    want = decode_attention_ref(q, k, v, sp, qp)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 3, 5])
@pytest.mark.parametrize("G", [3, 8, 12])
def test_paged_dense_family_groups_match_plain(card, dtype, G, T):
    """Paged decode and verify at Hkv = 8, Dh = 128 and G = 3, 8, 12.
    T * G above 32 rows (G = 12 at T = 3 and 5; G = 8 at T = 5) runs the
    kernel once per sub-group of heads, and the call counts once; G = 12
    is command-r-plus-104b's shape."""
    lengths = [1024, 700, 513, 512, 100, 17, T + 1, 16]
    q, kp, vp, bt, ln = _paged_inputs(card, dtype, 8, T, 8 * G, 8, 128, 16,
                                      64, lengths, seed=G * 10 + T)
    n0 = dops.paged_launches.get(T, 0)
    got = (paged_decode_attention(q[:, 0], kp, vp, bt, ln)[:, None] if T == 1
           else paged_verify_attention(q, kp, vp, bt, ln))
    torch.cuda.synchronize()
    assert dops.paged_launches[T] == n0 + 1
    want = paged_verify_attention_ref(q, kp, vp, bt, ln)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("T", [3, 5])
def test_paged_head_split_is_reproducible_and_row_independent(card, T):
    """A call split over head sub-groups (G = 12) repeats bitwise, and a
    row alone equals that row in the batch."""
    lengths = [1024, 700, 513, 100]
    q, kp, vp, bt, ln = _paged_inputs(card, "bfloat16", 4, T, 96, 8, 128,
                                      16, 64, lengths, seed=T + 96)
    a = paged_verify_attention(q, kp, vp, bt, ln)
    b = paged_verify_attention(q, kp, vp, bt, ln)
    assert torch.equal(a, b)
    for row in (0, 2):
        alone = paged_verify_attention(q[row:row + 1].contiguous(), kp, vp,
                                       bt[row:row + 1].contiguous(),
                                       ln[row:row + 1].contiguous())
        assert torch.equal(alone[0], a[row])


@pytest.mark.parametrize("arch", ["ministral-3b", "qwen3-32b",
                                  "phi4-mini-3.8b", "minicpm-2b"])
def test_lm_head_at_dense_family_vocabularies(card, arch):
    """The bf16 LM head at the family's full vocabularies and widths
    (131072, 151936, 200064 tied, 122753 tied and odd): float32 logits
    close to the upcast product, and no float32 copy of the head."""
    cfg = dataclasses.replace(REGISTRY[arch], dtype="bfloat16")
    g = torch.Generator(device=card).manual_seed(cfg.vocab_size)
    w = (torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                     device=card) * 0.02).to(torch.bfloat16)
    params = ({"embed": w} if cfg.tie_embeddings
              else {"lm_head": w.T.contiguous()})
    head = w.T
    del w
    h = torch.randn((8, cfg.d_model), generator=g,
                    device=card).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = TM.lm_logits(params, cfg, h)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert got.dtype == torch.float32 and got.shape == (8, cfg.vocab_size)
    torch.testing.assert_close(got, h.float() @ head.float(), atol=2e-2,
                               rtol=2e-2)
    assert extra < head.numel() * 2, extra


# ---------------------------------------------------------------------------
# Sliding window and mixture of experts (gemma2, the MoE configs, jamba)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,kv_len", [(512, 128, 400), (640, 256, 640)])
def test_flash_window_binds_past_its_length(card, dtype, S, window, kv_len):
    """gemma2's local layers at a reduced size: a prompt several windows
    long (whole 64-row tiles masked out behind the band), softcap 50,
    G = 2 at head dim 128, a row padded past its length."""
    g = torch.Generator(device=card).manual_seed(S + window)
    dt = getattr(torch, dtype)
    q = torch.randn((2, S, 32, 128), generator=g, device=card).to(dt)
    k = torch.randn((2, S, 16, 128), generator=g, device=card).to(dt)
    v = torch.randn((2, S, 16, 128), generator=g, device=card).to(dt)
    kw = dict(causal=True, window=window, softcap=50.0,
              kv_len=torch.tensor([kv_len, S], dtype=torch.int32,
                                  device=card))
    n0 = fops.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.launches == n0 + 1
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [256, None])
def test_ring_wrapped_with_softcap_matches_plain(card, dtype, window):
    """gemma2's decode at a reduced size: rings of 256 slots that wrapped
    (every slot written, positions out of slot order), softcap 50, G = 2;
    with ``window`` equal to the ring (a local layer) and without (a
    global layer's ring shorter than the context)."""
    C = 256
    g = torch.Generator(device=card).manual_seed(C + (window or 0))
    dt = getattr(torch, dtype)
    written = torch.tensor([600, 257, 1000, 300], device=card)
    q = torch.randn((4, 32, 128), generator=g, device=card).to(dt)
    k = torch.randn((4, C, 16, 128), generator=g, device=card).to(dt)
    v = torch.randn((4, C, 16, 128), generator=g, device=card).to(dt)
    c = torch.arange(C, device=card)
    slot_pos = (written[:, None] - 1
                - torch.remainder(written[:, None] - 1 - c, C)).to(torch.int32)
    q_pos = (written - 1).to(torch.int32)
    kw = dict(window=window, softcap=50.0)
    n0 = dops.launches
    got = decode_attention(q, k, v, slot_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert dops.launches == n0 + 1
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, k, v, slot_pos, q_pos,
                                          **kw).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def _moe_cfg(dtype="bfloat16", capacity_factor=1.0):
    cfg = REGISTRY["qwen3-moe-30b-a3b"].reduced()
    return dataclasses.replace(
        cfg, dtype=dtype,
        moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def test_moe_decode_step_repeats_bitwise_and_replays_as_eager(card):
    """Reduced qwen3-moe at capacity factor 1.0 (entries drop): a decode
    step run twice on copies of one cache is bitwise equal, and 16 steps
    replayed from a CUDA graph equal 16 eager steps bit for bit."""
    from functools import partial

    from repro_torch.models import layers as L

    cfg = _moe_cfg()
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    B = 8
    g = torch.Generator(device=card).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, 48), device=card,
                         generator=g, dtype=torch.int32)
    lengths = torch.tensor([48, 30, 17, 48, 5, 40, 1, 33], dtype=torch.int32,
                           device=card)
    _, cache = TM.prefill(params, cfg, toks, lengths, max_len=128)
    dropped = []
    inner = L.moe_ffn_sorted

    def spy(*a, **k):
        out, aux = inner(*a, **k)
        dropped.append(int(aux["dropped"]))
        return out, aux

    L.moe_ffn_sorted = spy
    try:
        runs = [TM.decode_step(params, cfg, toks[:, 0], _tree_clone(cache),
                               lengths) for _ in range(2)]
    finally:
        L.moe_ffn_sorted = inner
    assert sum(dropped) > 0, "capacity factor 1.0 should drop at 8 rows"
    assert torch.equal(runs[0][0], runs[1][0])
    assert _tree_equal(runs[0][1], runs[1][1])
    inputs = [dict(tokens=toks[:, 0], lengths=lengths + i) for i in range(16)]
    counts = _graph_vs_eager(partial(TM.decode_step_greedy, cfg=cfg), params,
                             cache, inputs, chain=True)
    assert counts == {("decode_attention", "launches"): cfg.n_layers * 16}


def test_moe_layer_at_qwen3_moe_width_repeats_and_captures(card):
    """``moe_ffn_sorted`` at a qwen3-moe decode step's shape (8 rows, 128
    experts of 768, top-8, C = 1): two calls are bitwise equal, and a
    CUDA graph of the call (no host sync inside) replays it bitwise."""
    from repro_torch.models import layers as L

    cfg = REGISTRY["qwen3-moe-30b-a3b"]
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    g = torch.Generator(device=card).manual_seed(9)

    def w(*shape, s=0.02):
        return (torch.randn(shape, generator=g, device=card) * s).bfloat16()

    x = w(8, d, s=1.0)
    args = (x, w(d, E), w(E, d, f), w(E, d, f), w(E, f, d))
    kw = dict(top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor)
    a, aux = L.moe_ffn_sorted(*args, **kw)
    b, _ = L.moe_ffn_sorted(*args, **kw)
    assert torch.equal(a, b) and int(aux["dropped"]) > 0
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        L.moe_ffn_sorted(*args, **kw)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        out, _ = L.moe_ffn_sorted(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, a)


def test_moe_row_alone_routes_as_in_a_batch(card):
    """Where capacity binds no entry (capacity factor 4.0 in the reduced
    qwen3-moe), each row of a batch alone picks the experts it picked in
    the batch and gives the same output within the bf16 tolerance."""
    from repro_torch.models import layers as L

    cfg = _moe_cfg(capacity_factor=4.0)
    e = cfg.moe
    g = torch.Generator(device=card).manual_seed(11)

    def w(*shape, s=0.5):
        return (torch.randn(shape, generator=g, device=card) * s).bfloat16()

    x = w(8, cfg.d_model, s=1.0)
    args = (w(cfg.d_model, e.num_experts), w(e.num_experts, cfg.d_model,
                                             e.d_ff_expert),
            w(e.num_experts, cfg.d_model, e.d_ff_expert),
            w(e.num_experts, e.d_ff_expert, cfg.d_model))
    kw = dict(top_k=e.top_k, capacity_factor=e.capacity_factor)
    batch, aux = L.moe_ffn_sorted(x, *args, **kw)
    assert int(aux["dropped"]) == 0
    _, _, experts, _ = L._route(x, args[0], e.top_k, e.capacity_factor)
    for r in range(x.shape[0]):
        alone, _ = L.moe_ffn_sorted(x[r:r + 1], *args, **kw)
        _, _, mine, _ = L._route(x[r:r + 1], args[0], e.top_k,
                                 e.capacity_factor)
        assert torch.equal(mine[0], experts[r])
        torch.testing.assert_close(alone[0].float(), batch[r].float(),
                                   atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"])


# ---------------------------------------------------------------------------
# hubert-xlarge's encoder (head dim 80, bidirectional) and int8 serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(16, 16), (16, 4)], ids=["G1", "G4"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "kv_len"])
def test_flash_dh80_bidirectional_matches_plain(card, dtype, Hq, Hkv,
                                                ragged):
    """Head dim 80 without the causal mask: every key of a row up to its
    ``kv_len`` (padded frames mask keys for every query row, pad rows
    included; a row of length 0 averages V), against the plain version,
    and a second call repeats the first bitwise."""
    g = torch.Generator(device=card).manual_seed(80 + Hkv)
    dt = getattr(torch, dtype)
    B, S, Dh = 3, 300, 80
    q = torch.randn((B, S, Hq, Dh), generator=g, device=card).to(dt)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=card).to(dt)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=card).to(dt)
    kl = torch.tensor([S, 131, 0], dtype=torch.int32, device=card) \
        if ragged else None
    kw = dict(causal=False, kv_len=kl)
    n0 = fops.launches
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.launches == n0 + 2
    assert torch.equal(got, again)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    causal = attention_ref(q, k, v, causal=True, kv_len=kl)
    assert float((causal.float() - got.float()).abs().max()) > 0.1


def test_decode_wrappers_refuse_dh80_before_launch(card):
    """The decode kernels instantiate head dims 16, 64 and 128 only: a
    ring or paged call at 80 is refused by its wrapper, and no kernel
    launches."""
    q = torch.zeros((2, 4, 80), device=card, dtype=torch.bfloat16)
    ring = torch.zeros((2, 32, 4, 80), device=card, dtype=torch.bfloat16)
    pos = torch.arange(32, dtype=torch.int32, device=card).expand(2, 32)
    lens = torch.tensor([20, 32], dtype=torch.int32, device=card)
    pages = torch.zeros((5, 16, 4, 80), device=card, dtype=torch.bfloat16)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=card)
    before = (dops.launches, dict(dops.paged_launches))
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, ring, ring, pos.contiguous(), lens)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q, pages, pages, bt, lens)
    with pytest.raises(ValueError, match="head_dim"):
        paged_verify_attention(q[:, None].expand(2, 3, 4, 80).contiguous(),
                               pages, pages, bt, lens)
    torch.cuda.synchronize()
    assert (dops.launches, dict(dops.paged_launches)) == before


def test_hubert_forward_kernel_path_matches_plain_path(card):
    """The reduced hubert at head dim 80 in bfloat16 on frame embeddings
    with padded rows: the kernel path (one flash launch a layer) against
    the plain path."""
    cfg = dataclasses.replace(REGISTRY["hubert-xlarge"].reduced(),
                              head_dim=80, dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((3, 200, cfg.d_model), generator=g, device=card)
    lengths = torch.tensor([200, 77, 150], dtype=torch.int32, device=card)
    n0 = fops.launches
    hk, _ = TM.forward(params, cfg, inputs_embeds=x, lengths=lengths)
    torch.cuda.synchronize()
    assert fops.launches == n0 + cfg.n_layers
    hp, _ = TM.forward(params, cfg, inputs_embeds=x, lengths=lengths,
                       plain_attention=True)
    assert fops.launches == n0 + cfg.n_layers
    torch.testing.assert_close(hk.float(), hp.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def test_int8_graph_replay_equals_eager_decode(card):
    """Reduced llama in bf16 with int8 weights and an int8 ring: 16 decode
    steps replayed from a CUDA graph equal 16 eager steps bit for bit,
    ids, codes and scales, one ring launch a layer a step."""
    from functools import partial

    cfg, params = _reduced("llama-3.1-8b", "bfloat16")
    cfg = dataclasses.replace(cfg, weight_dtype="int8", kv_dtype="int8")
    params = TM.quantize_params(params)
    assert TM.params_quantized(params)
    B, steps = 8, 16
    g = torch.Generator(device=card).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, 48), device=card,
                         generator=g, dtype=torch.int32)
    lengths = torch.tensor([48, 30, 17, 48, 5, 40, 1, 33], dtype=torch.int32,
                           device=card)
    _, cache = TM.prefill(params, cfg, toks, lengths, max_len=128)
    assert cache["layer_0"]["k"].dtype == torch.int8
    assert set(cache["layer_0"]) == {"k", "v", "pos", "k_sc", "v_sc"}
    inputs = [dict(tokens=toks[:, 0], lengths=lengths + i)
              for i in range(steps)]
    counts = _graph_vs_eager(partial(TM.decode_step_greedy, cfg=cfg), params,
                             cache, inputs, chain=True)
    assert counts == {("decode_attention", "launches"): cfg.n_layers * steps}
