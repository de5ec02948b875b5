"""Plain-PyTorch version of the prefill flash-attention kernel."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) int: keys >= kv_len masked
    q_start: Optional[torch.Tensor] = None,  # (B,) int: position of q row 0
) -> torch.Tensor:
    """Direct (fully materialized) attention.  Key j sits at position j;
    query row i at ``q_start[b] + i`` (``i`` without ``q_start``).
    Without ``kv_len`` and ``q_start`` it is ``repro``'s
    ``attention_ref``; with them, it is ``L.chunked_attention`` given
    ``q_positions = q_start + i`` and ``kv_valid = pos < kv_len``."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) / math.sqrt(Dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device).expand(B, Sq)
    if q_start is not None:
        qpos = qpos + q_start.to(q.device)[:, None]
    qpos = qpos[:, :, None]  # (B, Sq, 1)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    if kv_len is not None:
        mask = mask & (kpos[None] < kv_len.to(q.device)[:, None, None])
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, Dh).to(q.dtype)
