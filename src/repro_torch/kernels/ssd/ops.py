"""Wrapper of the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

A CUDA tensor launches the Hopper kernel (or raises); a CPU tensor takes
the plain version in ``ref.py``.  ``launches`` counts the calls that
launched.  In bfloat16 a call is two launches, the C.B^T pre-pass and the
scan; it counts once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_ref

launches = 0
_fn = None

STATE_DIMS = (16, 32, 64, 128)  # reduced configs, the sweep, mamba2 (128)
P_TILE = 16  # head-dim columns per block; the head dim must be a multiple


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.repro_ssd_scan
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        scratch = lib.repro_ssd_scan_scratch_floats
        scratch.argtypes = [ctypes.c_int] * 3
        scratch.restype = ctypes.c_longlong
        lib.repro_ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssd_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, scratch, lib.repro_ssd_scan_error_string)
    return _fn


@functools.lru_cache(maxsize=None)
def _cb_scratch_floats(B: int, S: int, code: int) -> int:
    """Floats of the C.B^T scratch the kernel needs for (B, S, dtype
    code): the library sizes its own sub-chunks (0 in float32)."""
    return int(_kernel()[1](B, S, code))


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32 post-softplus
    A: torch.Tensor,  # (H,) fp32 negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
):
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32),
    from a zero state: the Pallas ``ssd_scan``.  Its contract holds:
    ``chunk = min(chunk, S)`` must divide S.  The kernel tiles the
    sequence in 64-row sub-chunks of its own (exact algebra: rounding
    only), and reads x, B and C through their batch and sequence
    strides, so the model's slices of one ``(B, S, conv_dim)`` tensor go
    in without a copy."""
    global launches
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"x {tuple(x.shape)} does not match dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunk must divide the sequence: {(S, chunk)}")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    code = _build.dtype_code(x)
    if not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"dtypes differ: x {x.dtype}, B {Bm.dtype}, "
                        f"C {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not in {STATE_DIMS}")
    if P % P_TILE:
        raise ValueError(f"head dim {P} is not a multiple of {P_TILE}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError("x must have contiguous (H, P) rows")
    if Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("B and C must have contiguous rows")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("dt and A must be contiguous")
    if code == 1:  # copied in 16-byte pieces through their strides
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                        for st in t.stride()[:2]):
                raise ValueError(f"{name} must be 16-byte aligned, its "
                                 "batch and sequence strides too")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state
    fn, _, err_str = _kernel()
    n_cb = _cb_scratch_floats(B, S, code)
    cb = (torch.empty(n_cb, dtype=torch.float32, device=x.device)
          if n_cb else None)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            cb.data_ptr() if cb is not None else None,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), B, S, H, P, N, code,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"ssd_scan launch failed: {err_str(err).decode()} ({err})"
        )
    launches += 1
    return y, state
