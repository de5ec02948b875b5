"""Wrappers of the prefill flash-attention kernel (``csrc/flash_prefill.cu``)
and its backward (``csrc/flash_backward.cu``).

A CUDA tensor launches the Hopper kernel (or raises); a CPU tensor takes
the plain version in ``ref.py``, which autograd differentiates.  On the
card, a call that needs a gradient goes through :class:`_FlashAttention`:
its forward launches ``flash_prefill`` with the row log-sum-exp saved,
its backward launches ``flash_backward``.  ``launches`` counts forward
launches (``head_launches`` the same by query heads Hq, which on a mesh
slice are the rank's share), ``q_offset_launches`` those among them that
took ``q_start``,
``backward_launches`` the backward calls (one C call on one stream: a
pre-pass, then one wgmma kernel or two mma.sync / CUDA-core kernels, as
:func:`backward_body` says).  Under
:func:`repro_torch.device.analysis_mode` a call on meta tensors is
traced: it counts and reports its cost (:func:`flash_cost`,
:func:`flash_backward_cost`) and returns outputs of the launch's shapes
without building the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import on_card
from repro_torch.kernels import _build, record_cost
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_ref,
    attention_ref,
)

launches = 0
head_launches: Dict[int, int] = {}
q_offset_launches = 0
backward_launches = 0
_fn = None
_bwd = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_prefill")
        fn = lib.repro_flash_prefill
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_flash_prefill_error_string.argtypes = [ctypes.c_int]
        lib.repro_flash_prefill_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_flash_prefill_error_string)
    return _fn


def _backward_kernel():
    global _bwd
    if _bwd is None:
        lib = _build.load("flash_backward")
        fn = lib.repro_flash_backward
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        sizes = []
        for kind in ("floats", "ints"):
            size = getattr(lib, f"repro_flash_backward_scratch_{kind}")
            size.argtypes = [ctypes.c_int] * 7
            size.restype = ctypes.c_longlong
            sizes.append(size)
        lib.repro_flash_backward_body.argtypes = [ctypes.c_int] * 2
        lib.repro_flash_backward_body.restype = ctypes.c_int
        lib.repro_flash_backward_error_string.argtypes = [ctypes.c_int]
        lib.repro_flash_backward_error_string.restype = ctypes.c_char_p
        _bwd = (fn, tuple(sizes), lib.repro_flash_backward_body,
                lib.repro_flash_backward_error_string)
    return _bwd


# the bodies of flash_backward.cu, as its repro_flash_backward_body
# numbers them
BACKWARD_BODIES = ("cuda_cores", "mma_sync", "wgmma")
BWD_TILE_Q = 64  # the wgmma body's query tile ...
BWD_TILE_K = 128  # ... and key tile


def backward_body(code: int, Dh: int) -> str:
    """The body of ``flash_backward.cu`` that serves dtype ``code`` at head
    dim ``Dh``: float32 on the CUDA cores (every head dim of
    ``FLASH_HEAD_DIMS``); bf16 at Dh 64 and 128 in one pass on wgmma and
    TMA, at Dh 16 and 80 in two passes on mma.sync."""
    dims = _build.FLASH_HEAD_DIMS if code == 0 else _build.FLASH_BF16_HEAD_DIMS
    if Dh not in dims or code not in (0, 1):
        raise ValueError(f"no flash_backward body for dtype code {code} at "
                         f"head_dim {Dh}")
    if code == 0:
        return "cuda_cores"
    return "wgmma" if Dh in (64, 128) else "mma_sync"


def backward_scratch_shapes(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                            Dh: int, code: int) -> Dict[str, tuple]:
    """The scratch a ``flash_backward`` call takes, by name, float32
    first, then int32 (zeroed): ``delta`` (B, Hq, Sq) for the two-pass
    bodies; for the wgmma body ``lse_delta`` by query tile, ``dq_sums``
    (each query tile's dQ partials added in key-tile order), with G > 1
    ``dkv_sums`` (a (b, kv head, key tile)'s dK and dV added in split
    order, whatever :func:`backward_split` picks), then ``ticket``,
    ``turns`` (one counter per (b, q head, query tile)) and, with G > 1,
    ``kv_turns`` (per (b, kv head, key tile) and consumer warpgroup).  The
    library sizes the same
    (``repro_flash_backward_scratch_*``)."""
    if backward_body(code, Dh) != "wgmma":
        return {"delta": (B, Hq, Sq)}
    n_qt = -(-Sq // BWD_TILE_Q)
    n_kt = -(-Skv // BWD_TILE_K)
    shapes = {"lse_delta": (B, Hq, n_qt, 2, BWD_TILE_Q),
              "dq_sums": (B, Hq, n_qt, BWD_TILE_Q, Dh)}
    if Hq > Hkv:
        shapes["dkv_sums"] = (2, B, Hkv, n_kt * BWD_TILE_K, Dh)
    shapes.update(ticket=(1,), turns=(B, Hq, n_qt))
    if Hq > Hkv:
        shapes["kv_turns"] = (B, Hkv, n_kt, 2)
    return shapes


def backward_split(Sq: int, Skv: int, Hq: int, Hkv: int, Dh: int,
                   causal: bool, window: Optional[int], code: int) -> int:
    """How many work items the wgmma body makes of each (batch row, kv
    head, 128-key tile) on the current card: each takes G / split of the
    kv head's G query heads in turn, holding dK and dV in registers, and
    with split > 1 they add dK and dV through ``dkv_sums`` in split order.
    The library counts one batch row's tiles, so the batch size does not
    enter and a row alone sums in its batch's order; 0 for the other
    bodies.  Card only."""
    fn = _build.load("flash_backward").repro_flash_backward_split
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    return int(fn(Sq, Skv, Hq, Hkv, Dh, int(causal),
                  int(window) if window is not None else 0, code))


@functools.lru_cache(maxsize=None)
def _backward_scratch_sizes(*shape_and_dtype: int) -> Tuple[int, int]:
    """(floats, int32s) of scratch the library asks for (B, Sq, Skv, Hq,
    Hkv, Dh, dtype code)."""
    floats, ints = _backward_kernel()[1]
    return int(floats(*shape_and_dtype)), int(ints(*shape_and_dtype))


def _backward_scratch(q: torch.Tensor, k: torch.Tensor, code: int):
    """The float32 scratch and the zeroed int32 scratch (None where the
    body takes none) of one call, sized by the library."""
    B, Sq, Hq, Dh = q.shape
    n_f, n_i = _backward_scratch_sizes(B, Sq, k.shape[1], Hq, k.shape[2],
                                       Dh, code)
    scratch = torch.empty(n_f, dtype=torch.float32, device=q.device)
    ints = (torch.zeros(n_i, dtype=torch.int32, device=q.device)
            if n_i else None)
    return scratch, ints


def attention_pairs(B: int, Sq: int, Skv: int, *, causal: bool,
                    window: Optional[int] = None,
                    q_start: Union[None, int, Sequence[int]] = None,
                    lens: Optional[Sequence[int]] = None) -> int:
    """Unmasked (query row, key) pairs of one query head over ``B`` rows:
    query row i of batch row b at position ``q_start[b] + i`` (an int
    for every row; 0 without), the keys of row b at ``0 .. lens[b] - 1``
    (``Skv`` without), causal and windowed as the kernel masks them."""
    starts = (list(q_start) if isinstance(q_start, (list, tuple))
              else [q_start or 0] * B)
    lens = [Skv] * B if lens is None else list(lens)
    memo: Dict[Tuple[int, int], int] = {}
    total = 0
    for s0, n in zip(starts, lens):
        if (s0, n) not in memo:
            qpos = np.arange(s0, s0 + Sq, dtype=np.int64)
            hi = np.minimum(qpos, n - 1) if causal else np.full_like(
                qpos, n - 1)
            lo = (np.zeros_like(qpos) if window is None
                  else np.maximum(qpos - window + 1, 0))
            memo[(s0, n)] = int(np.clip(hi - lo + 1, 0, None).sum())
        total += memo[(s0, n)]
    return total


def flash_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, Dh: int,
               esz: int, *, causal: bool, window: Optional[int] = None,
               q_start: Union[None, int, Sequence[int]] = None,
               lens: Optional[Sequence[int]] = None) -> Tuple[float, float]:
    """(flops, bytes) of one ``flash_prefill`` launch: 4 Dh operations a
    valid (query, key) pair and query head; q read and out written once,
    each row's valid keys' K and V read once (``esz`` bytes an
    element)."""
    pairs = attention_pairs(B, Sq, Skv, causal=causal, window=window,
                            q_start=q_start, lens=lens) * Hq
    keys = B * Skv if lens is None else sum(lens)
    nbytes = (2 * B * Sq * Hq * Dh + 2 * keys * Hkv * Dh) * esz
    return 4.0 * pairs * Dh, float(nbytes)


def flash_backward_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                        Dh: int, esz: int, *, causal: bool,
                        window: Optional[int] = None) -> Tuple[float, float]:
    """(flops, bytes) of one ``flash_backward`` call: per valid (query,
    key) pair and query head S = q.k, dP = dO.v, dV += P dO, dK += dS q,
    dQ += dS k (10 Dh); q, out, dout and k, v read once, dq, dk, dv
    written once, and the float32 lse read once."""
    pairs = attention_pairs(B, Sq, Skv, causal=causal,
                            window=window) * Hq
    nbytes = (4 * B * Sq * Hq * Dh + 4 * B * Skv * Hkv * Dh) * esz \
        + B * Hq * Sq * 4
    return 10.0 * pairs * Dh, float(nbytes)


_INT_SCRATCH = ("ticket", "turns", "kv_turns")


def _traced_scratch(q: torch.Tensor, k: torch.Tensor, code: int):
    """A traced backward's scratch on q's (meta) device, sized by
    :func:`backward_scratch_shapes` as the library sizes the real one:
    (floats, int32s)."""
    B, Sq, Hq, Dh = q.shape
    shapes = backward_scratch_shapes(B, Sq, k.shape[1], Hq, k.shape[2], Dh,
                                     code)
    n = [sum(int(np.prod(s)) for name, s in shapes.items()
             if (name in _INT_SCRATCH) == is_int) for is_int in (False, True)]
    return (torch.empty(n[0], dtype=torch.float32, device=q.device),
            torch.empty(n[1], dtype=torch.int32, device=q.device))


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, _, Hq, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def _check_card(q, k, named) -> int:
    """The checks every launch makes; returns the dtype code."""
    code = _build.dtype_code(q)
    Dh = q.shape[3]
    dims = _build.FLASH_HEAD_DIMS if code == 0 else _build.FLASH_BF16_HEAD_DIMS
    if Dh not in dims:
        raise ValueError(f"head_dim {Dh} not in {dims} ({q.dtype})")
    G = q.shape[2] // k.shape[2]
    if code == 1 and G > 64:  # a bf16 forward block holds 64 (pos, head) rows
        raise ValueError(f"at most 64 q heads per kv head, got {G}")
    for name, t in named:
        _build.check_operand(name, t, q.device)
    return code


def _launch(q, k, v, causal, window, softcap, kv_len, q_start,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``flash_prefill`` launch; ``lse`` (float32, (B, Hq, Sq)), when
    given, receives each row's log-sum-exp."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    code = _check_card(q, k, (("q", q), ("k", k), ("v", v)))
    for name, t in (("kv_len", kv_len), ("q_start", q_start)):
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        _build.check_operand(name, t, q.device, align=4)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.is_meta:  # traced (analysis mode): no kernel
        return _counted(out, q, k, causal, window, q_start)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            kv_len.data_ptr() if kv_len is not None else None,
            q_start.data_ptr() if q_start is not None else None,
            B, Sq, Skv, Hq, Hkv, Dh, int(causal),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            1.0 / Dh ** 0.5, code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"flash_prefill launch failed: {err_str(err).decode()} ({err})"
        )
    return _counted(out, q, k, causal, window, q_start)


def _counted(out, q, k, causal, window, q_start):
    """Count one ``flash_prefill`` launch and report its cost from the
    shapes (every key valid; with ``q_start`` the rows taken to end at the
    last key)."""
    global launches, q_offset_launches
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    launches += 1
    head_launches[Hq] = head_launches.get(Hq, 0) + 1
    q_offset_launches += q_start is not None
    record_cost("flash_prefill", flash_cost, B, Sq, Skv, Hq, Hkv, Dh,
                q.element_size(), causal=causal, window=window,
                q_start=None if q_start is None else Skv - Sq)
    return out


def flash_backward(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    out: torch.Tensor,  # (B, Sq, Hq, Dh), the forward's output
    dout: torch.Tensor,  # (B, Sq, Hq, Dh)
    lse: Optional[torch.Tensor],  # (B, Hq, Sq) float32, the forward's
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,
    q_start: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` (without ``kv_len`` and
    ``q_start``) at ``dout``, in q's dtype.  On the card one call of
    ``flash_backward.cu`` (the body :func:`backward_body` names); on a
    CPU tensor the plain backward (:func:`ref.attention_backward_ref`,
    which needs neither ``out`` nor ``lse``).  ``kv_len`` and ``q_start`` are refused: the
    training path never passes them."""
    if kv_len is not None or q_start is not None:
        raise ValueError("flash_backward takes no kv_len or q_start: the "
                         "training path attends over whole rows from 0")
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        dq, dk, dv = attention_backward_ref(q, k, v, dout, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if not on_card(q):
        raise ValueError(f"no flash_backward for device {q.device}")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out {out.dtype} and dout {dout.dtype} must be "
                        f"{q.dtype}")
    if lse is None or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"lse must be float32 ({B}, {Hq}, {Sq})")
    code = _check_card(q, k, (("q", q), ("k", k), ("v", v), ("out", out),
                              ("dout", dout)))
    _build.check_operand("lse", lse, q.device, align=4)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if q.is_meta:  # traced: the scratch the library sizes, no kernel
        _traced_scratch(q, k, code)
        return _backward_counted(dq, dk, dv, q, k, causal, window)
    fn, _, _, err_str = _backward_kernel()
    with torch.cuda.device(q.device):
        scratch, ints = _backward_scratch(q, k, code)
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            ints.data_ptr() if ints is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Skv, Hq, Hkv, Dh, int(causal),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            1.0 / Dh ** 0.5, code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"flash_backward launch failed: {err_str(err).decode()} ({err})"
        )
    return _backward_counted(dq, dk, dv, q, k, causal, window)


def _backward_counted(dq, dk, dv, q, k, causal, window):
    """Count one ``flash_backward`` call and report its cost."""
    global backward_launches
    B, Sq, Hq, Dh = q.shape
    backward_launches += 1
    record_cost("flash_backward", flash_backward_cost, B, Sq, k.shape[1],
                Hq, k.shape[2], Dh, q.element_size(), causal=causal,
                window=window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op on the card: the forward
    keeps (q, k, v, out, lse) for the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, causal, window, softcap, None, None, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over a non-contiguous view
        dq, dk, dv = flash_backward(q, k, v, out, dout.contiguous(), lse,
                                    **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) int32
    q_start: Optional[torch.Tensor] = None,  # (B,) int32
) -> torch.Tensor:
    """GQA prefill attention; returns (B, Sq, Hq, Dh) in q's dtype.
    Without ``kv_len`` and ``q_start`` it equals the Pallas
    ``flash_attention``; with them, ``L.chunked_attention`` given
    ``q_positions = q_start + i`` and ``kv_valid = pos < kv_len`` (key j
    at position j) — the paged prefill after a prefix hit.  On the card
    a call under autograd that needs a gradient runs the kernel pair
    (:class:`_FlashAttention`), and refuses ``kv_len`` and ``q_start``."""
    _check_shapes(q, k, v)
    B = q.shape[0]
    rows = {"kv_len": kv_len, "q_start": q_start}
    for name, t in rows.items():
        if t is not None and tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, kv_len=kv_len, q_start=q_start)
    if not on_card(q):
        raise ValueError(f"no flash_attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_len is not None or q_start is not None:
            raise ValueError("flash_attention has no backward with kv_len "
                             "or q_start: the training path never takes "
                             "them")
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _launch(q, k, v, causal, window, softcap, kv_len, q_start)
