"""Wrappers of the Mamba2 SSD chunked-scan kernel (``csrc/ssd_scan.cu``)
and its backward (``csrc/ssd_backward.cu``).

A CUDA tensor launches the Hopper kernel (or raises); a CPU tensor takes
the plain version in ``ref.py``, which autograd differentiates.  On the
card, a call that needs a gradient goes through :class:`_SSDScan`: its
forward launches ``ssd_scan`` writing the state entering each 64-row
sub-chunk, its backward launches ``ssd_backward``.  ``launches`` counts
forward calls that launched (``head_launches`` the same by the call's
head count H, which on a mesh slice is the rank's share), and
``backward_launches`` backward calls.  In
bfloat16 a forward call is two launches, the C.B^T pre-pass and the scan;
a backward call is three (the state gradient's walk, the sub-chunks, the
sums over head groups); each call counts once.  Under
:func:`repro_torch.device.analysis_mode` a call on meta tensors is
traced: it counts and reports its cost (:func:`ssd_scan_cost`,
:func:`ssd_backward_cost`) and returns outputs of the launch's shapes
without building the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import on_card
from repro_torch.kernels import _build, record_cost
from repro_torch.kernels.ssd.ref import ssd_backward_ref, ssd_ref

launches = 0
head_launches: Dict[int, int] = {}
backward_launches = 0
_fn = None
_bwd = None

STATE_DIMS = (16, 32, 64, 128)  # reduced configs, the sweep, mamba2 (128)
P_TILE = 16  # head-dim columns per block; the head dim must be a multiple
SUB_CHUNK = 64  # the kernels' sequence rows per sub-chunk
HEAD_GROUP = 8  # heads a bf16 backward block sums dB and dC over
BWD_BF16_MAX_P = 64  # the largest head dim of the bf16 backward


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.repro_ssd_scan
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 6
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


def _backward_kernel():
    global _bwd
    if _bwd is None:
        lib = _build.load("ssd_backward")
        fn = lib.repro_ssd_backward
        fn.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        scratch = lib.repro_ssd_backward_scratch_floats
        scratch.argtypes = [ctypes.c_int] * 7
        scratch.restype = ctypes.c_longlong
        lib.repro_ssd_backward_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssd_backward_error_string.restype = ctypes.c_char_p
        _bwd = (fn, scratch, lib.repro_ssd_backward_error_string)
    return _bwd


def states_shape(B: int, S: int, H: int, P: int, N: int) -> Tuple[int, ...]:
    """The forward's training output: the state entering each sub-chunk
    (``ssd_backward.cu``'s ``repro_ssd_backward_scratch_floats(0, ...)``;
    a card test ties the two)."""
    return (B, -(-S // SUB_CHUNK), H, P, N)


def backward_scratch_shapes(B: int, S: int, H: int, P: int, N: int,
                            code: int):
    """The backward's float32 scratch for dtype ``code``, as the library
    sizes it: the state gradient leaving each sub-chunk, the partial sums
    of dB and of dC (one a head in float32, one a group of
    :data:`HEAD_GROUP` heads in bf16), the per-(row, sub-chunk) terms of
    dA."""
    states = states_shape(B, S, H, P, N)
    groups = -(-H // HEAD_GROUP) if code == 1 else H
    return (states, (B, S, groups, N), (B, S, groups, N), states[:3])


def ssd_scan_cost(B: int, S: int, H: int, P: int, N: int, chunk: int,
                  esz: int, states: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one ``ssd_scan`` call with the reference's
    ``chunk``: per chunk of L = min(chunk, S) rows the causal half of
    C.B^T (shared by the heads) and per head the intra-chunk, inter-chunk
    and state products; x, dt, A, B, C read once, y and the final state
    written once (and the sub-chunk states with ``states``)."""
    L = min(chunk, S)
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * esz \
        + (B * S * H + H + B * H * P * N) * 4
    if states:
        nbytes += 4 * B * -(-S // SUB_CHUNK) * H * P * N
    flops = float(B * (S // L)) * (L * (L + 1) * N
                                    + H * (L * (L + 1) * P + 4 * L * N * P))
    return flops, float(nbytes)


def ssd_backward_cost(B: int, S: int, H: int, P: int, N: int, esz: int,
                      dstate: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one ``ssd_backward`` call: per (b, h) and 64-row
    sub-chunk of T = 64 * 65 / 2 causal pairs, dy.x^T, the intra-chunk
    dx, dB and dC (T P, T P, 2 T N) and the state terms of dx, dB, dC and
    the state gradient's walk (4 L N P), C.B^T (T N) once per (b,
    sub-chunk), two operations a multiply-add; x, dt, A, B, C, dy (and
    dstate) read once and dx, ddt, dA, dB, dC written once (the forward's
    states and the scratch are the design's own traffic)."""
    L = SUB_CHUNK
    n_sub = -(-S // L)
    T = L * (L + 1) // 2
    nbytes = (3 * B * S * H * P + 4 * B * S * N) * esz \
        + (2 * B * S * H + 2 * H) * 4 + (4 * B * H * P * N if dstate else 0)
    macs = B * n_sub * (T * N + H * (2 * T * P + 2 * T * N + 4 * L * N * P))
    return 2.0 * macs, float(nbytes)


def _check_shapes(x, dt, A, Bm, Cm, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"x {tuple(x.shape)} does not match dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunk must divide the sequence: {(S, chunk)}")


def _check_card(x, dt, A, Bm, Cm) -> int:
    """The kernels' operand rules; returns the dtype code."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
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
    return code


def _launch(x, dt, A, Bm, Cm, states: Optional[torch.Tensor] = None,
            chunk: int = 256):
    """One ``repro_ssd_scan`` call on checked card operands; ``states``
    (float32, :func:`states_shape`) receives the state entering each
    sub-chunk, for the backward.  ``chunk`` (the reference's) only
    enters the reported cost."""
    code = _check_card(x, dt, A, Bm, Cm)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state
    if x.is_meta:  # traced (analysis mode): no kernel
        return _counted(y, state, N, chunk, states is not None)
    fn, _, err_str = _kernel()
    n_cb = _cb_scratch_floats(B, S, code)
    cb = (torch.empty(n_cb, dtype=torch.float32, device=x.device)
          if n_cb else None)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            cb.data_ptr() if cb is not None else None,
            states.data_ptr() if states is not None else None,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), B, S, H, P, N, code,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"ssd_scan launch failed: {err_str(err).decode()} ({err})"
        )
    return _counted(y, state, N, chunk, states is not None)


def _counted(y, state, N: int, chunk: int, states: bool):
    """Count one ``ssd_scan`` call and report its cost."""
    global launches
    B, S, H, P = y.shape
    launches += 1
    head_launches[H] = head_launches.get(H, 0) + 1
    record_cost("ssd_scan", ssd_scan_cost, B, S, H, P, N, chunk,
                y.element_size(), states)
    return y, state


def ssd_backward(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32
    A: torch.Tensor,  # (H,) fp32
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    dy: torch.Tensor,  # (B, S, H, P), x's dtype
    states: Optional[torch.Tensor],  # states_shape(...) fp32, the forward's
    dstate: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
):
    """(dx, ddt, dA, dB, dC) of :func:`ssd_scan` at the cotangents ``dy``
    of y and ``dstate`` of the final state (zero when None): dx in x's
    dtype, dB and dC in B's, ddt and dA float32.  On the card one call of
    ``ssd_backward.cu``, reading the ``states`` the training forward wrote;
    on a CPU tensor the plain backward (:func:`ref.ssd_backward_ref`, which
    needs no ``states``)."""
    _check_shapes(x, dt, A, Bm, Cm, x.shape[1])
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dy.shape) != (B, S, H, P):
        raise ValueError(f"dy {tuple(dy.shape)} must be x's {tuple(x.shape)}")
    if dstate is not None and tuple(dstate.shape) != (B, H, P, N):
        raise ValueError(f"dstate {tuple(dstate.shape)} must be "
                         f"{(B, H, P, N)}")
    if x.device.type == "cpu":
        dx, ddt, dA, dB, dC = ssd_backward_ref(x, dt, A, Bm, Cm, dy, dstate)
        return dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype)
    if not on_card(x):
        raise ValueError(f"no ssd_backward for device {x.device}")
    code = _check_card(x, dt, A, Bm, Cm)
    if dy.dtype != x.dtype:
        raise TypeError(f"dy {dy.dtype} must be {x.dtype}")
    if code == 1 and P > BWD_BF16_MAX_P:
        raise ValueError(f"the bf16 backward takes head dims up to "
                         f"{BWD_BF16_MAX_P}, got {P}")
    # the bf16 body copies dy in 16-byte pieces
    _build.check_operand("dy", dy, x.device, align=16 if code == 1 else 4)
    if dstate is not None:
        if dstate.dtype != torch.float32:
            raise TypeError(f"dstate must be float32, got {dstate.dtype}")
        _build.check_operand("dstate", dstate, x.device, align=4)
    if states is None or states.dtype != torch.float32 \
            or tuple(states.shape) != states_shape(B, S, H, P, N):
        raise ValueError("states must be the training forward's float32 "
                         f"{states_shape(B, S, H, P, N)}")
    _build.check_operand("states", states, x.device, align=4)
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    dA = torch.empty((H,), dtype=torch.float32, device=x.device)
    dB = torch.empty((B, S, N), dtype=Bm.dtype, device=x.device)
    dC = torch.empty((B, S, N), dtype=Cm.dtype, device=x.device)
    if dx.numel() == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    dS, dBp, dCp, dAp = (
        torch.empty(shape, dtype=torch.float32, device=x.device)
        for shape in backward_scratch_shapes(B, S, H, P, N, code))
    if x.is_meta:  # traced (analysis mode): no kernel
        return _backward_counted((dx, ddt, dA, dB, dC), N, dstate)
    fn, _, err_str = _backward_kernel()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(),
            dstate.data_ptr() if dstate is not None else None,
            states.data_ptr(), dS.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            dAp.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(),
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), B, S, H, P, N, code,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"ssd_backward launch failed: {err_str(err).decode()} ({err})"
        )
    return _backward_counted((dx, ddt, dA, dB, dC), N, dstate)


def _backward_counted(grads, N: int, dstate):
    """Count one ``ssd_backward`` call and report its cost."""
    global backward_launches
    B, S, H, P = grads[0].shape
    backward_launches += 1
    record_cost("ssd_backward", ssd_backward_cost, B, S, H, P, N,
                grads[0].element_size(), dstate is not None)
    return grads


class _SSDScan(torch.autograd.Function):
    """The kernel pair as one differentiable op: the forward keeps
    (x, dt, A, B, C) and the states it wrote for the backward kernel.  On
    a CPU tensor (the tests) the forward is the plain scan and the
    backward the plain backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk=256):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            states = None
            y, state = ssd_ref(x, dt, A, Bm, Cm)
        else:
            B, S, H, P = x.shape
            states = torch.empty(states_shape(B, S, H, P, Bm.shape[-1]),
                                 dtype=torch.float32, device=x.device)
            y, state = _launch(x, dt, A, Bm, Cm, states, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        # autograd may hand over a non-contiguous or offset view; the bf16
        # kernel copies dy in 16-byte pieces
        dy = dy.contiguous()
        if dy.data_ptr() % 16:
            dy = dy.clone()
        return (*ssd_backward(x, dt, A, Bm, Cm, dy, states,
                              None if dstate is None
                              else dstate.contiguous()), None)


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
    in without a copy.  On the card a call under autograd that needs a
    gradient runs the kernel pair (:class:`_SSDScan`)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm)
    if not on_card(x):
        raise ValueError(f"no ssd_scan for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    return _launch(x, dt, A, Bm, Cm, chunk=chunk)
