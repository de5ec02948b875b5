"""Model building blocks of the dense path: norms, RoPE, attention
(chunked prefill / ring decode), SwiGLU/GeGLU MLP.

Counterpart of ``repro/models/layers.py``, function for function, with
the same layouts and quirks: ``rms_norm`` scales by ``(1 + w)``, RoPE
uses the half-split layout, masks use the finite ``NEG_INF``, softmax
and normalisation accumulate in float32.  These are the plain-PyTorch
layers: the model runs its attention through the Hopper kernels in
``repro_torch.kernels`` and keeps these as the oracle and the plain
path.  MoE, SSD, conv and ``sliding_attention`` join with the other
architectures.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ref import decode_attention_ref

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> sin/cos of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., Dh); sin/cos broadcastable to (..., Dh//2)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    # broadcast sin/cos over the head axis: x is (B,S,H,Dh), sin is (B,S,half)
    while sin.dim() < x1.dim():
        sin = sin[..., None, :]
        cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_positions: Optional[torch.Tensor] = None,  # (B, Sq) int
    kv_positions: Optional[torch.Tensor] = None,  # (B, Skv) int
    kv_valid: Optional[torch.Tensor] = None,  # (B, Skv) bool
    q_chunk: int = 512,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Memory-bounded attention (online softmax over kv chunks); returns
    (B, Sq, Hq, Dh) in q.dtype."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Skv)
    if Sq % q_chunk or Skv % k_chunk:
        raise ValueError(f"chunks must divide: {(Sq, q_chunk, Skv, k_chunk)}")
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev).expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev).expand(B, Skv)
    if kv_valid is None:
        kv_valid = torch.ones((B, Skv), dtype=torch.bool, device=dev)

    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, Hkv, G, Dh)
        qpos = q_positions[:, q0:q0 + q_chunk]
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dh), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Skv, k_chunk):
            kc = k[:, k0:k0 + k_chunk]
            vc = v[:, k0:k0 + k_chunk]
            kpos = kv_positions[:, k0:k0 + k_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kc.float()) * scale
            s = _softcap(s, softcap)
            mask = kv_valid[:, k0:k0 + k_chunk][:, None, None, None, :]
            if causal:
                mask = mask & (
                    qpos[:, None, None, :, None] >= kpos[:, None, None, None, :]
                )
            if window is not None:
                mask = mask & (
                    qpos[:, None, None, :, None] - kpos[:, None, None, None, :]
                    < window
                )
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-37)[..., None]
        # (B, Hkv, G, qc, Dh) -> (B, qc, Hkv, G, Dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, Dh))
    return torch.cat(outs, dim=1).to(q.dtype)


# Attention of one new token over a (ring-buffer) KV cache: the same
# computation as the ring-decode kernel's plain version, so the layer is
# that function.
decode_attention = decode_attention_ref


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def glu_mlp(x, w_gate, w_in, w_out, act: str):
    """SwiGLU/GeGLU: out = (act(x@w_gate) * (x@w_in)) @ w_out."""
    g = _act(x @ w_gate, act)
    h = g * (x @ w_in)
    return h @ w_out
