"""AdamW with float32 moments and the LR schedules (MiniCPM's WSD, cosine).

Counterpart of ``repro/training/optimizer.py``, op for op in its
arithmetic order: the clip scale ``min(1, clip / (gnorm + 1e-9))``, the
moments from the scaled gradient, the bias corrections as float32
``b ** step`` on a tensor, and ``p - lr * (mhat / (sqrt(vhat) + eps) +
wd * p)`` in float32, cast back to the parameter's dtype (no float32
master copy, as in the reference).  The global norm sums the leaves in
JAX's flatten order (dict keys sorted).

The optimizer state mirrors the params (``m`` and ``v``) with an int32
``step`` tensor.  Unlike the reference's pure function,
:func:`adamw_update` writes the new params and moments **in place**: at
minicpm-2b's full width a second copy of params, ``m`` and ``v`` would
take 27 GB of the card.  A large leaf is updated in slices along its
first dim (:data:`SLICE` elements at a time): the update is elementwise,
so the slices give the same bits, and its float32 temporaries stay
small (mamba2-2.7b's stacked ``in_proj`` has 1.73 B elements; whole, the
temporaries of one update took over 30 GB).  A divisor is a tensor on the operand's device
(:func:`_div`): the card multiplies by the reciprocal of a host scalar,
which rounds differently.  :func:`opt_state_specs` is the reference
layout's spec of the state (the dry-run's); mesh training, which would
place the state by it, is ROADMAP queue 1, item 13.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.training._tree import leaves, tree_map

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


# elements of a leaf that one AdamW update handles at a time
SLICE = 1 << 26


def _slices(t: torch.Tensor):
    """``t`` as views along its first dim of at most about :data:`SLICE`
    elements each (whole rows; ``t`` itself when small or 0-dim)."""
    if t.dim() == 0 or t.numel() <= SLICE:
        return (t,)
    rows = max(1, SLICE // (t.numel() // t.shape[0]))
    return t.split(rows, 0)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on every device."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def init_opt_state(params: PyTree) -> Dict[str, PyTree]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)[0]
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def opt_state_specs(param_specs: PyTree) -> Dict[str, PyTree]:
    """The reference layout's specs of the optimizer state: the moments
    mirror the params' specs, ``step`` is a scalar (the spec ``()``)."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(
    params: PyTree,
    grads: PyTree,
    state: Dict[str, PyTree],
    cfg: AdamWConfig,
    lr: torch.Tensor,
) -> Tuple[PyTree, Dict[str, PyTree]]:
    """One AdamW step; updates ``params`` and ``state``'s moments in place
    and returns (params, state) with the new ``step``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32,
                      device=gnorm.device)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    sf = step.float()
    corr1 = 1 - torch.pow(cfg.b1, sf)
    corr2 = 1 - torch.pow(cfg.b2, sf)
    pieces = (zip(*map(_slices, leaf)) for leaf in zip(
        leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["v"])))
    for p, g, m, v in (piece for leaf in pieces for piece in leaf):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mhat = m / corr1
        vhat = v / corr2
        pf = p.float()
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    state["step"] = step
    return params, state


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def wsd_schedule(
    warmup: int, stable: int, decay: int,
    peak_lr: float, min_lr_frac: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat plateau,
    exponential decay to ``min_lr_frac * peak`` over the decay span."""

    def f(step):
        s = _steps(step)
        warm = peak_lr * torch.clamp(_div(s, max(warmup, 1)), max=1.0)
        in_decay = torch.clamp(s - (warmup + stable), min=0.0)
        frac = torch.clamp(_div(in_decay, max(decay, 1)), max=1.0)
        dec = peak_lr * torch.pow(min_lr_frac, frac)
        return torch.where(s <= warmup + stable, warm, dec)

    return f


def cosine_schedule(
    warmup: int, total: int, peak_lr: float, min_lr_frac: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    def f(step):
        s = _steps(step)
        warm = peak_lr * torch.clamp(_div(s, max(warmup, 1)), max=1.0)
        t = torch.clamp(_div(s - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = peak_lr * (
            min_lr_frac
            + (1 - min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        )
        return torch.where(s <= warmup, warm, cos)

    return f
