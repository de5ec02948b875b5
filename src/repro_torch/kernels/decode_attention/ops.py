"""Wrapper of the ring decode-attention kernel (``csrc/ring_decode.cu``).

A CUDA tensor launches the Hopper kernel (or raises); a CPU tensor takes
the plain version in ``ref.py``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ring_decode")
        fn = lib.repro_ring_decode
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_ring_decode_error_string.argtypes = [ctypes.c_int]
        lib.repro_ring_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_ring_decode_error_string)
    return _fn


def decode_attention(
    q: torch.Tensor,  # (B, Hq, Dh)
    k_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    v_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    slot_pos: torch.Tensor,  # (B, C) int32, -1 == empty slot
    q_pos: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One new token per row over the ring cache; (B, Hq, Dh) in q's dtype."""
    global launches
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    B, Hq, Dh = q.shape
    _, C, Hkv, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != Dh or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k_cache.shape)}")
    if tuple(slot_pos.shape) != (B, C) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"slot_pos {tuple(slot_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match ({B}, {C})")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, slot_pos, q_pos,
                                    window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    code = _build.dtype_code(q)
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {_build.HEAD_DIMS}")
    if Hq // Hkv > 32:
        raise ValueError(f"at most 32 q heads per kv head, got {Hq // Hkv}")
    if slot_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("slot_pos and q_pos must be int32")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_operand(name, t, q.device)
    for name, t in (("slot_pos", slot_pos), ("q_pos", q_pos)):
        _build.check_operand(name, t, q.device, align=4)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
            B, C, Hq, Hkv, Dh,
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            1.0 / Dh ** 0.5, code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"ring_decode launch failed: {err_str(err).decode()} ({err})"
        )
    launches += 1
    return out
