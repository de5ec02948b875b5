"""Gradient compression (int8 + error feedback) for DP bandwidth relief.

Counterpart of ``repro/training/compress.py``.  Per-leaf symmetric int8
quantization with an error-feedback residual:

    q      = round(clip((g + err) / scale))      scale = max|g + err| / 127
    err'   = (g + err) - q * scale

Error feedback makes the compression unbiased over time (the
quantization residual re-enters the next step).  Rounding is half to
even (``torch.round``, as ``jnp.round``), and every division is a true
division by a tensor on the operand's device, not a multiply by a
reciprocal, so the codes, scales and residuals are the reference's bit
for bit.  ``launch/train.py``'s ``--compress-grads`` is the reference's
no-op: the two functions here are the wire format, applied where a
data-parallel all-reduce would run.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training._tree import leaves, tree_map, unflatten

PyTree = Any


def init_error_state(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(grads: PyTree, err: PyTree) -> Tuple[PyTree, PyTree, PyTree]:
    """Returns (int8 q, fp32 scales, new error state)."""

    def one(g, e):
        gf = g.float() + e
        top = torch.full((), 127.0, dtype=torch.float32, device=gf.device)
        scale = torch.max(torch.abs(gf)) / top + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_e = gf - q.float() * scale
        return q, scale, new_e

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress(q: PyTree, scales: PyTree) -> PyTree:
    return tree_map(lambda qi, s: qi.float() * s, q, scales)


def compressed_wire_bytes(grads: PyTree) -> Tuple[int, int]:
    """(compressed, uncompressed-bf16) bytes for the DP all-reduce."""
    flat = leaves(grads)
    comp = sum(x.numel() for x in flat)  # int8: 1 B/elem
    raw = 2 * comp
    return comp + 4 * len(flat), raw
