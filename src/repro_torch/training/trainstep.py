"""The train step: chunked-vocab CE loss, remat, microbatch gradient
accumulation, MoE aux loss, AdamW.

Counterpart of ``repro/training/trainstep.py``.  The CE loss runs the
vocabulary projection one sequence chunk at a time under
``torch.utils.checkpoint``, so the (B, S, V) logits never exist at once
(the reference's ``jax.checkpoint`` over a ``lax.scan``).  On the card a
bf16 head multiplies bf16 hidden states into float32 logits, as the
reference's ``preferred_element_type`` does, through :class:`_Logits`,
with no float32 copy of the head.  The reference's ``_loss_sharding``
hint belongs to mesh training (ROADMAP queue 1, item 13).

A step runs the model's kernels on the card: ``flash_prefill`` in the
forward (twice a layer under remat: once more in the recompute) and
``flash_backward`` once a layer.  Gradients come from
``torch.autograd.grad`` on detached copies of the leaves, so the
caller's tensors keep ``requires_grad`` unset; :func:`adamw_update`
then updates params and moments in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import on_card
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training._tree import leaves, tree_map, unflatten
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    global_norm,
)

PyTree = Any


def _bf16_parts(x: torch.Tensor):
    """float32 ``x`` as hi + lo, two bf16 tensors (16 bits of mantissa)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


class _Logits(torch.autograd.Function):
    """(T, d) bf16 hidden states times the (d, V) bf16 head into float32
    logits on the card (``aten::mm.dtype``).  The backward takes the
    float32 cotangent as two bf16 parts, each multiplied into float32,
    and rounds each gradient to bf16 once: the head is never upcast."""

    @staticmethod
    def forward(ctx, h, head):
        ctx.save_for_backward(h, head)
        return torch.mm(h, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, head = ctx.saved_tensors
        hi, lo = _bf16_parts(g)
        dh = dhead = None
        if ctx.needs_input_grad[0]:
            dh = (torch.mm(hi, head.T, out_dtype=torch.float32)
                  + torch.mm(lo, head.T, out_dtype=torch.float32))
            dh = dh.to(h.dtype)
        if ctx.needs_input_grad[1]:
            dhead = (torch.mm(h.T, hi, out_dtype=torch.float32)
                     + torch.mm(h.T, lo, out_dtype=torch.float32))
            dhead = dhead.to(head.dtype)
        return dh, dhead


def _logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """float32 logits of (B, c, d) ``h`` against the (d, V) head."""
    B, c, d = h.shape
    if on_card(h) and h.dtype == head.dtype == torch.bfloat16:
        return _Logits.apply(h.reshape(B * c, d), head).reshape(B, c, -1)
    return h.float() @ head.float()


def _chunk_loss(h_c, y_c, head, softcap):
    logits = _logits(h_c, head)
    if softcap is not None:
        logits = L._softcap(logits, softcap)
    valid = y_c >= 0
    y_safe = torch.clamp(y_c, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum(), valid.sum(dtype=torch.int32)


def chunked_ce_loss(
    params: PyTree,
    cfg: ModelConfig,
    hidden: torch.Tensor,  # (B, S, d)
    labels: torch.Tensor,  # (B, S) int; -100 == ignore
    chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over valid labels, streaming the vocab projection."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"the CE chunk {chunk} must divide S={S}")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    labels = labels.to(hidden.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, S, chunk):
        s, n = torch.utils.checkpoint.checkpoint(
            _chunk_loss, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            head, cfg.logit_softcap, use_reentrant=False,
            preserve_rng_state=False)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1), cnt


@dataclass(frozen=True)
class TrainStepConfig:
    """The reference's fields, plus ``plain_attention``: the port's plain
    layers instead of the kernels (the oracle on the card)."""
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    remat: bool = True
    microbatches: int = 1
    moe_aux_weight: float = 0.01
    ce_chunk: int = 512
    plain_attention: bool = False


def make_loss_fn(cfg: ModelConfig, tcfg: TrainStepConfig):
    def loss_fn(params, batch):
        hidden, moe_loss = M.forward(
            params,
            cfg,
            tokens=batch.get("tokens"),
            inputs_embeds=batch.get("inputs_embeds"),
            plain_attention=tcfg.plain_attention,
            remat=tcfg.remat,
        )
        ce, n_tok = chunked_ce_loss(
            params, cfg, hidden, batch["labels"], tcfg.ce_chunk
        )
        loss = ce + tcfg.moe_aux_weight * moe_loss
        return loss, {"ce": ce, "moe_aux": moe_loss, "tokens": n_tok}

    return loss_fn


def make_grad_fn(cfg: ModelConfig, tcfg: TrainStepConfig):
    """``grad_fn(params, batch) -> ((loss, aux), grads)``, the
    counterpart of ``jax.value_and_grad(loss_fn, has_aux=True)``: grads
    in the params' dtypes, zeros for a leaf the loss does not reach.
    Refuses what the port does not train before any work
    (:func:`repro_torch.models.model.check_trainable`)."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def grad_fn(params, batch):
        M.check_trainable(cfg, params)
        live = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss, aux = loss_fn(unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        aux = {k: v.detach() for k, v in aux.items()}
        return (loss.detach(), aux), unflatten(params, grads)

    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainStepConfig,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), updating params and opt_state in place.

    ``microbatches > 1`` splits the batch dim and sums the microbatches'
    grads in float32, in order, then divides by their count; the loss is
    the mean and ``aux`` the last microbatch's (the reference's
    ``lax.scan``)."""
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb == 1:
            (loss, aux), grads = grad_fn(params, batch)
        else:
            dev = leaves(params)[0].device
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                (l, aux), g = grad_fn(params, part)
                for s, x in zip(leaves(gsum), leaves(g)):
                    s.add_(x.float())
                lsum = lsum + l
                del g
            n = torch.full((), float(mb), dtype=torch.float32, device=dev)
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n

        lr = lr_schedule(opt_state["step"])
        params, opt_state = adamw_update(
            params, grads, opt_state, tcfg.adamw, lr
        )
        metrics = {
            "loss": loss,
            "ce": aux["ce"],
            "grad_norm": global_norm(grads),
            "lr": lr,
        }
        return params, opt_state, metrics

    return train_step
