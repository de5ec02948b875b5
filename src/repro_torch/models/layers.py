"""Model building blocks: norms, RoPE, attention (chunked prefill /
banded sliding window / ring decode / speculative verify), SwiGLU/GeGLU
MLP, capacity-based MoE, and the Mamba2 mixer's SSD scan and depthwise
causal conv.

Counterpart of ``repro/models/layers.py``, function for function, with
the same layouts and quirks: ``rms_norm`` scales by ``(1 + w)``, RoPE
uses the half-split layout, masks use the finite ``NEG_INF``, softmax
and normalisation accumulate in float32.  These are the plain-PyTorch
layers: the model runs its attention and its prefill SSD scan through
the Hopper kernels in ``repro_torch.kernels`` and keeps these as the
oracle and the plain path.  MoE dispatch and the expert products are
plain PyTorch on both paths, as the JAX package computes them outside
any Pallas kernel.  ``analysis_mode`` (loop-free lowering for XLA's
cost analysis) has no counterpart: it comes with the dry-run (ROADMAP
queue 1, item 10).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.ssd import ref as ssd_ref

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


def sliding_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    softcap: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Banded local attention: each window-sized q band attends only to its
    own and the previous kv band (covers a causal window exactly), so FLOPs
    are O(S * 2W) instead of O(S^2).  Query and key positions are
    ``0..S-1``; S must be a whole number of windows when it exceeds one."""
    B, S, Hq, Dh = q.shape
    if S <= window:  # degenerates to plain causal attention
        return chunked_attention(
            q, k, v, causal=True, window=window, softcap=softcap,
            kv_valid=kv_valid, q_chunk=q_chunk,
        )
    if S % window:
        raise ValueError(f"the window must divide the sequence: "
                         f"{(S, window)}")
    n = S // window
    Hkv = k.shape[2]
    dev = q.device
    kb = k.reshape(B, n, window, Hkv, Dh)
    vb = v.reshape(B, n, window, Hkv, Dh)
    valid = (kv_valid.reshape(B, n, window) if kv_valid is not None
             else torch.ones((B, n, window), dtype=torch.bool, device=dev))
    # previous band (band -1 is invalid)
    val_prev = torch.roll(valid, 1, dims=1)
    val_prev[:, 0] = False
    kcat = torch.cat([torch.roll(kb, 1, dims=1), kb], dim=2)
    vcat = torch.cat([torch.roll(vb, 1, dims=1), vb], dim=2)
    valcat = torch.cat([val_prev, valid], dim=2)
    pos = torch.arange(S, device=dev).reshape(n, window)
    kpos = torch.cat([pos - window, pos], dim=1)  # (n, 2w)
    outs = []
    for i in range(n):
        outs.append(chunked_attention(
            q[:, i * window:(i + 1) * window], kcat[:, i], vcat[:, i],
            causal=True, window=window, softcap=softcap,
            q_positions=pos[i].expand(B, window),
            kv_positions=kpos[i].expand(B, 2 * window),
            kv_valid=valcat[:, i], q_chunk=q_chunk,
            k_chunk=min(1024, 2 * window),
        ))
    return torch.cat(outs, dim=1)


# Attention of one new token over a (ring-buffer) KV cache: the same
# computation as the ring-decode kernel's plain version, so the layer is
# that function.
decode_attention = decode_attention_ref


def verify_attention(
    q: torch.Tensor,  # (B, T, Hq, Dh) -- T new tokens per sequence
    k_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    v_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    slot_pos: torch.Tensor,  # (B, C) int absolute position per slot (-1 empty)
    q_pos: torch.Tensor,  # (B, T) int positions of the new tokens
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``T`` new tokens over a KV cache that already holds
    their K/V — the speculative verify pass.  Causality within the
    speculation window comes from per-token query positions; ``T == 1``
    is :func:`decode_attention`."""
    B, C, Hkv, Dh = k_cache.shape
    T, Hq = q.shape[1], q.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, T, Hkv, G, Dh).float()
    s = torch.einsum("bthgd,bchd->bthgc", qr, k_cache.float()) \
        * (1.0 / math.sqrt(Dh))
    s = _softcap(s, softcap)
    sp = slot_pos[:, None, :]
    qp = q_pos[:, :, None]
    mask = (sp >= 0) & (sp <= qp)
    if window is not None:
        mask = mask & (qp - sp < window)
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bthgc,bchd->bthgd", p, v_cache.float())
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


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


# ---------------------------------------------------------------------------
# MoE: capacity-based top-k dispatch
# ---------------------------------------------------------------------------


def _route(x, router, top_k: int, capacity_factor: float):
    """Router probabilities, each token's top-k experts and renormalised
    weights, and the capacity C per expert.  C comes from the static
    token count T (pad rows included), as in the JAX layer.  The top k
    come from a stable descending sort, so equal probabilities go to the
    lower expert index first, as ``lax.top_k`` breaks ties."""
    T = x.shape[0]
    E = router.shape[-1]
    C = max(1, int(math.ceil(T * top_k / E * capacity_factor)))
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :top_k], tope[:, :top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, tope, C


def _experts(xe, w_gate, w_in, w_out, act: str):
    """The dense per-expert GLU products over the (E, C, d) buffer."""
    g = _act(torch.bmm(xe, w_gate), act)
    h = g * torch.bmm(xe, w_in)
    return torch.bmm(h, w_out)  # (E, C, d)


def _combine(ybuf, slot, w, tope, dtype):
    """Each token's k expert rows of ``ybuf`` (its dump row last, all
    zero) weighted and summed over k in ascending expert order, one add
    at a time in ``dtype``: the order and the roundings of the JAX
    layer's scatter-add, and no float atomics.  ``slot`` and ``w`` are
    (T, k) in token-major order."""
    order = torch.argsort(tope, dim=1)
    slot = torch.gather(slot, 1, order)
    w = torch.gather(w, 1, order).to(dtype)
    out = torch.zeros((slot.shape[0], ybuf.shape[1]), dtype=dtype,
                      device=ybuf.device)
    for j in range(slot.shape[1]):
        out = out + ybuf[slot[:, j]] * w[:, j, None]
    return out


def _sorted_slots(flat_e, E: int, C: int):
    """The sort-based dispatch of token-major expert ids ``flat_e``:
    (order, slot of each sorted entry).  A stable sort keeps each
    expert's entries in token order (FIFO); an entry's rank in its
    expert comes from ``searchsorted`` over the sorted ids, and an entry
    ranked past C goes to the dump slot E·C."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(se.shape[0], device=se.device) - first
    return order, torch.where(rank < C, se * C + rank, E * C)


def quantize(x: torch.Tensor, dim: int):
    """Symmetric int8 over ``dim``: (codes int8, scale float32 with
    ``dim`` dropped), ``scale = max|x| / 127 + 1e-9`` and ``codes =
    clip(round(x / scale), -127, 127)`` in float32: the arithmetic of
    the reference's ``quantize_params`` (dim -2), ``quantize_kv`` and
    MoE row quantizer (dim -1).  The divisor is a tensor filled on
    ``x``'s device, so the card divides as the CPU does (it would
    multiply by the reciprocal of a CPU scalar) and a CUDA graph can
    capture it (no copy from the host)."""
    xf = x.float()
    sc = xf.abs().amax(dim=dim, keepdim=True).div_(
        torch.full((), 127.0, device=x.device)).add_(1e-9)
    q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
    return q, sc.squeeze(dim)


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 ``codes`` times float32 ``scale`` (broadcast to the codes'
    shape), computed in float32 and written in ``dtype``: the rounding
    of the reference's ``(codes.astype(f32) * scale).astype(dtype)``, in
    one pass that reads the codes and writes ``dtype`` (no float32
    copy)."""
    out = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    return torch.mul(codes, scale, out=out)


def _aux(probs, flat_e, keep, E: int):
    load = torch.zeros((E,), dtype=torch.int64, device=flat_e.device)
    load.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    return {"load": load, "dropped": (~keep).sum(), "me": probs.mean(dim=0)}


def moe_ffn_sorted(
    x: torch.Tensor,  # (T, d) flattened tokens
    router: torch.Tensor,  # (d, E)
    w_gate: torch.Tensor,  # (E, d, ffe)
    w_in: torch.Tensor,  # (E, d, ffe)
    w_out: torch.Tensor,  # (E, ffe, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
    dispatch_dtype: Optional[str] = None,
):
    """Sort-based capacity dispatch.  Returns (out (T, d), aux) with the
    per-expert ``load`` (before capacity), the ``dropped`` entry count
    and the mean router probabilities ``me``.

    Token→expert entries are sorted by expert id (:func:`_sorted_slots`)
    and those ranked past capacity C in their expert are dropped.  Kept
    entries take distinct slots of the (E·C, d) buffer, so dispatch is an index copy (dropped
    ones go to a dump row) and the combine gathers: no float atomics, so
    a call repeats bitwise.  ``dispatch_dtype="int8"`` quantizes the
    dispatch and combine buffers per row (:func:`quantize`, float32 scales)
    and the experts compute on the dequantized rows, as the JAX layer
    does; its scatter-add of int8 rows into distinct slots is the same
    copy.  The JAX layer's ``expert_sharding`` (the expert-parallel
    all-to-all) has no counterpart off a mesh (ROADMAP queue 1,
    item 8)."""
    T, d = x.shape
    E = router.shape[-1]
    probs, topw, tope, C = _route(x, router, top_k, capacity_factor)
    flat_e = tope.reshape(-1)  # (T*k,) token-major
    order, slot_sorted = _sorted_slots(flat_e, E, C)
    rows = x[order // top_k]
    if dispatch_dtype == "int8":
        # an empty slot keeps code 0 and scale 0, and dequantizes to 0
        codes, sc = quantize(rows, -1)
        buf = torch.zeros((E * C + 1, d), dtype=torch.int8, device=x.device)
        sbuf = torch.zeros((E * C + 1,), dtype=torch.float32,
                           device=x.device)
        buf[slot_sorted] = codes
        sbuf[slot_sorted] = sc
        xe = dequantize(buf[: E * C], sbuf[: E * C, None], x.dtype)
    else:
        buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
        buf[slot_sorted] = rows
        xe = buf[: E * C]
    ye = _experts(xe.view(E, C, d), w_gate, w_in, w_out, act)
    ye = ye.reshape(E * C, d)
    if dispatch_dtype == "int8":
        codes, sc = quantize(ye, -1)
        ye = dequantize(codes, sc[:, None], x.dtype)
    # back to token-major order for the combine
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    keep = slot < E * C
    ybuf = torch.cat([ye, ye.new_zeros((1, d))])
    w = topw * keep.view(T, top_k)
    out = _combine(ybuf, slot.view(T, top_k), w, tope, x.dtype)
    return out, _aux(probs, flat_e, keep, E)


def moe_ffn(
    x: torch.Tensor,  # (T, d) flattened tokens
    router: torch.Tensor,  # (d, E)
    w_gate: torch.Tensor,  # (E, d, ffe)
    w_in: torch.Tensor,  # (E, d, ffe)
    w_out: torch.Tensor,  # (E, ffe, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
):
    """Switch-style capacity dispatch through a (T·k, E) one-hot: an
    entry's slot in its expert is the exclusive cumulative count of that
    expert over the token-major entries.  Dropped entries (over
    capacity) land in a dump row and pass with weight 0.  Returns
    (out (T, d), aux) as :func:`moe_ffn_sorted`, which it equals."""
    T, d = x.shape
    E = router.shape[-1]
    probs, topw, tope, C = _route(x, router, top_k, capacity_factor)
    flat_e = tope.reshape(-1)  # (T*k,) token-major => FIFO per expert
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).long()
    pos = torch.cumsum(onehot, dim=0) - onehot  # exclusive cumsum
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e, E * C)  # dump slot
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x.repeat_interleave(top_k, dim=0)
    ye = _experts(buf[: E * C].view(E, C, d), w_gate, w_in, w_out, act)
    ybuf = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    w = topw * keep.view(T, top_k)
    out = _combine(ybuf, slot.view(T, top_k), w, tope, x.dtype)
    return out, _aux(probs, flat_e, keep, E)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32, post-softplus
    A: torch.Tensor,  # (H,) fp32 negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Chunked state-space-duality scan. Returns (y (B,S,H,P), state).

    The JAX layer solves the inter-chunk recurrence
    ``st_c = dec_c * st_{c-1} + s_c`` with an associative scan; here it
    is a loop over chunks: the same recurrence, summed in another order
    (float32 rounding only)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunk must divide the sequence: {(S, chunk)}")
    nc = S // chunk

    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtc = dt.float().reshape(Bsz, nc, chunk, H)
    Bc = Bm.float().reshape(Bsz, nc, chunk, N)
    Cc = Cm.float().reshape(Bsz, nc, chunk, N)

    a = dtc * A  # (B, nc, L, H), negative
    cum = torch.cumsum(a, dim=2)  # inclusive cumsum over chunk

    # ---- intra-chunk (quadratic within chunk) ----
    # decay(i, j) = exp(cum_i - cum_j) for i >= j; exp is taken only
    # there (above the diagonal seg > 0 could overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,L,L,H)
    li = torch.arange(chunk, device=x.device)
    tri = (li[:, None] >= li[None, :])[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    cb = torch.einsum("bcln,bcmn->bclm", Cc, Bc)  # (B,nc,L,L)
    att = cb[..., None] * decay * dtc[:, :, None, :, :]  # dt_j at j=m
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", att, xf)

    # ---- chunk states ----
    # state_c = sum_j exp(cum_last - cum_j) * dt_j * B_j (outer) x_j
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,L,H)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", dec_last * dtc, Bc, xf)

    # ---- inter-chunk recurrence, one chunk after another ----
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    st = (init_state.float() if init_state is not None
          else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                           device=x.device))
    entry = []  # state *entering* each chunk
    for c in range(nc):
        entry.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    entry_states = torch.stack(entry, dim=1)  # (B,nc,H,P,N)

    # contribution of the carried state within each chunk:
    # y_inter[l] = C_l . (exp(cum_l) * state_entry)
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cc, torch.exp(cum),
                           entry_states)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), st


# One token of the SSD recurrence: the step of the SSD kernel's plain
# version (the token recurrence), so the layer is that function.
ssd_decode_step = ssd_ref.ssd_decode_step


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, D), w: (D, K). Returns (B, S, D)."""
    K = w.shape[-1]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        shift = K - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi.float() * w[:, i].float()
    return out.to(x.dtype)


def conv_step(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor):
    """One decode step of the depthwise causal conv.

    x: (B, D); conv_state: (B, K-1, D) previous inputs; w: (D, K).
    Returns (y (B, D), new_conv_state (B, K-1, D)).
    """
    K = w.shape[-1]
    hist = torch.cat([conv_state, x[:, None, :]], dim=1)  # (B, K, D)
    y = torch.einsum("bkd,dk->bd", hist.float(), w.float()).to(x.dtype)
    return y, hist[:, 1:K, :] if K > 1 else conv_state
