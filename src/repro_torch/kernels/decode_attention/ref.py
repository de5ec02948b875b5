"""Plain-PyTorch version of the ring decode-attention kernel."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, Dh)
    k_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    v_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    slot_pos: torch.Tensor,  # (B, C) int, -1 == empty slot
    q_pos: torch.Tensor,  # (B,) int
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Direct single-token attention over the cache (fully materialized).
    A row with every slot empty averages V over the C slots."""
    B, C, Hkv, Dh = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, Dh).float()
    s = torch.einsum("bhgd,bchd->bhgc", qr, k_cache.float()) / math.sqrt(Dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (slot_pos >= 0) & (slot_pos <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - slot_pos < window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bchd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, Dh).to(q.dtype)
