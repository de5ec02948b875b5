"""Plain-PyTorch versions of the ring and paged decode-attention kernels."""
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


def paged_verify_attention_ref(
    q: torch.Tensor,  # (B, T, Hq, Dh) — T query tokens per sequence
    k_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    v_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    block_tables: torch.Tensor,  # (B, Pmax) int page ids, -1 = unused
    lengths: torch.Tensor,  # (B,) int valid tokens incl. the T new ones
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Gather every table page (-1 clamps to page 0) into a dense
    per-sequence cache, then masked attention with the T query tokens at
    positions ``lengths - T + t``, causal within the speculation window.
    A row with no valid key averages V over all ``Pmax * page_size``
    gathered positions (the paged kernel returns 0 for ``length == 0``)."""
    P, ps, Hkv, Dh = k_pages.shape
    B, Pmax = block_tables.shape
    T, Hq = q.shape[1], q.shape[2]
    G = Hq // Hkv
    C = Pmax * ps
    bt = torch.clamp(block_tables.long(), min=0)
    kc = k_pages[bt].reshape(B, C, Hkv, Dh).float()
    vc = v_pages[bt].reshape(B, C, Hkv, Dh).float()
    lengths = lengths.to(device=q.device, dtype=torch.long)
    pos = torch.arange(C, device=q.device)[None, None]  # (1, 1, C)
    q_pos = lengths[:, None] - T + torch.arange(T, device=q.device)[None]
    mask = (pos < lengths[:, None, None]) & (pos <= q_pos[..., None])
    if window is not None:
        mask = mask & (q_pos[..., None] - pos < window)
    qr = q.reshape(B, T, Hkv, G, Dh).float()
    s = torch.einsum("bthgd,bchd->bthgc", qr, kc) / math.sqrt(Dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bthgc,bchd->bthgd", p, vc)
    return o.reshape(B, T, Hq, Dh).to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, Dh)
    k_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    v_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    block_tables: torch.Tensor,  # (B, Pmax) int page ids, -1 = unused
    lengths: torch.Tensor,  # (B,) int valid tokens incl. the current one
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """The ``T == 1`` case of :func:`paged_verify_attention_ref`."""
    return paged_verify_attention_ref(
        q[:, None], k_pages, v_pages, block_tables, lengths,
        window=window, softcap=softcap,
    )[:, 0]
