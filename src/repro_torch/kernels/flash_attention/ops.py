"""Wrapper of the prefill flash-attention kernel (``csrc/flash_prefill.cu``).

A CUDA tensor launches the Hopper kernel (or raises); a CPU tensor takes
the plain version in ``ref.py``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_prefill")
        fn = lib.repro_flash_prefill
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_flash_prefill_error_string.argtypes = [ctypes.c_int]
        lib.repro_flash_prefill_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_flash_prefill_error_string)
    return _fn


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) int32
) -> torch.Tensor:
    """GQA prefill attention; returns (B, Sq, Hq, Dh) in q's dtype.
    Without ``kv_len`` it equals the Pallas ``flash_attention``; with it,
    ``L.chunked_attention`` given ``kv_valid = pos < kv_len``."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len is not None and tuple(kv_len.shape) != (B,):
        raise ValueError(f"kv_len must be ({B},), got {tuple(kv_len.shape)}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    code = _build.dtype_code(q)
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {_build.HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, q.device)
    if kv_len is not None:
        if kv_len.dtype != torch.int32:
            raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
        _build.check_operand("kv_len", kv_len, q.device, align=4)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None,
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
    launches += 1
    return out
