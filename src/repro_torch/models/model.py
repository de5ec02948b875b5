"""Model of the port: init, forward, prefill and dense-cache decode, and
the paged pool's prefill, decode and speculative verify.

Counterpart of ``repro/models/model.py`` for attention (global or
sliding-window, causal or bidirectional) and Mamba2 (SSD) mixers with an
MLP, a MoE or no FFN: the dense family, gemma2, the MoE configs, mamba2,
jamba and the hubert encoder (fed frame embeddings through
``inputs_embeds``; it has no decode phase).  Parameters keep the stacked
``params["blocks"]`` layout with a leading ``n_blocks`` axis, so JAX
weights carry across leaf for leaf (:mod:`repro_torch.models.bridge`);
``lax.scan`` over blocks becomes a Python loop over that axis.

**int8.**  :func:`quantize_params` gives the reference's serving layout
(``{"q8", "sc"}`` per block matrix), which every entry point
dequantizes block by block at block entry (:func:`_dequant_tree`), as
the JAX model does; the products then run on the dequantized block in
the model dtype.  ``kv_dtype="int8"`` stores the dense ring as int8
codes with a float32 scale per (position, head): prefill attention runs
on the unquantized K/V, and decode writes the new position's codes,
then dequantizes the whole ring and attends over it.

Where the JAX model calls ``L.chunked_attention``,
``L.decode_attention``, ``L.verify_attention`` and ``L.ssd_chunked``,
this model calls the Hopper kernels' wrappers
(:mod:`repro_torch.kernels`), which take their plain PyTorch versions
for CPU tensors.  ``plain_attention=True`` runs the ported layers for
every mixer instead, as the JAX model does — the replay oracle on the
card.  Mamba2 decode (``L.conv_step``, ``L.ssd_decode_step``), the
banded plain form of a windowed layer (``L.sliding_attention``; the
flash kernel masks the window itself) and the MoE FFN
(``L.moe_ffn_sorted``) are plain PyTorch on both paths where the JAX
model computes them outside any Pallas kernel.  Caches (ring, recurrent
and paged) are updated in place; the JAX model returns new ones.

**Mesh slices.**  Under :func:`repro_torch.distributed.mesh_context`
every function runs on this rank's local shards (cut by
:mod:`repro_torch.distributed.sharding`) with Megatron tensor
parallelism made explicit on the slice's ``"model"`` group: an
all-reduce after ``wo`` and after ``w_out``, a vocab-parallel embedding
(rows outside the local range give 0, then an all-reduce) and a
vocab-sharded LM head whose float32 logits are all-gathered before any
argmax, so every rank sees the full row and emits the same token.
Whether a weight is a shard is read off its local shape against the
config's, so a layer whose heads do not divide the axis keeps its
attention weights and KV cache whole, and at width 1 nothing is split
and no collective runs: the meshless path, op for op.  Attention runs
on local heads; the decode-attention wrappers run their sharded branch
on them (``on_local_heads``, no DTensor) and count its launches (``flash_attention`` needs no wrapper: it has no ``mesh=``
in the JAX package either).  Mamba2, MoE and every int8 mode on a mesh
wider than 1 raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.kernels.decode_attention.ops import on_local_heads
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import layers as L

Params = Dict[str, Any]
PyTree = Any


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Reject what the port does not serve yet: Mamba2, MoE and int8 on
    a mesh wider than 1 (ROADMAP queue 1, item 8)."""
    _check_mesh(cfg, ctx.axis_size("model"))


def _int8_modes(cfg: ModelConfig):
    """The int8 modes ``cfg`` asks for: weights, KV, MoE dispatch."""
    return [name for name, on in (
        ("weights", cfg.weight_dtype == "int8"),
        ("KV", cfg.kv_dtype == "int8"),
        ("MoE dispatch",
         cfg.moe is not None and cfg.moe.dispatch_dtype == "int8")) if on]


def _check_mesh(cfg: ModelConfig, width: int) -> None:
    if width <= 1:
        return
    if cfg.has_mamba or cfg.moe is not None:
        raise NotImplementedError(
            f"model '{cfg.name}': Mamba2 (SSD heads over 'model') and MoE "
            "(experts over 'model') on a mesh wider than 1 are ROADMAP "
            "queue 1, item 8"
        )
    modes = _int8_modes(cfg)
    if modes:
        raise NotImplementedError(
            f"model '{cfg.name}': int8 {', '.join(modes)} on a mesh wider "
            "than 1 is ROADMAP queue 1, item 8 (a column-parallel leaf's "
            "scales must be cut with its output dim)"
        )


def _index(tree, i: int):
    """Block ``i`` of the stacked ``params["blocks"]`` tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None, mesh=None) -> Params:
    """Random weights with the shapes, standard deviations and dtypes of
    ``repro.models.model.init_params``, drawn from ``generator`` (which
    lives on ``device``).  Stacked leaves fill block by block, so the
    float32 draw never holds more than one block's matrix.  With
    ``mesh`` (a slice) only this rank's shard of each draw is kept: the
    same numbers as the meshless call, cut as
    :func:`repro_torch.distributed.sharding.shard_params` cuts them.
    With ``weight_dtype="int8"`` the tree is the float one, as the
    reference's ``init_params`` gives it: :func:`quantize_params` makes
    the serving layout."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n = cfg.n_blocks
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)
    if mesh is None:
        def cut(path, x, stacked):
            return x
    else:
        _check_mesh(cfg, ctx.model_width(mesh))

        def cut(path, x, stacked):
            return SH.local_shard(x, SH.leaf_placement(cfg, path, mesh), mesh,
                                  offset=-1 if stacked else 0)

    def normal(shape, s, path=None):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        x = (x * s).to(dt)
        return x if path is None else cut(path, x, False)

    def stacked(shape, s, path):
        out = None
        for i in range(n):
            blk = cut(path, normal(shape, s), True)
            if out is None:
                out = torch.empty((n, *blk.shape), dtype=dt, device=dev)
            out[i] = blk
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def uniform(lo, hi, *shape):  # float32, as the JAX model keeps it
        u = torch.rand(shape, generator=generator, device=dev,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff

    def init_attn(path):
        p = {
            "norm": zeros(n, d),
            "wq": stacked((d, qd), std, path + ("wq",)),
            "wk": stacked((d, kvd), std, path + ("wk",)),
            "wv": stacked((d, kvd), std, path + ("wv",)),
            "wo": stacked((qd, d), out_std, path + ("wo",)),
        }
        if cfg.qk_norm:
            p["q_norm"] = zeros(n, cfg.head_dim)
            p["k_norm"] = zeros(n, cfg.head_dim)
        return p

    def init_mamba(path):
        m = cfg.mamba
        di, nh = m.d_inner(d), m.n_heads(d)
        conv_dim = di + 2 * m.d_state
        in_dim = 2 * di + 2 * m.d_state + nh  # z, x, B, C, dt
        # dt bias: inverse softplus of dt ~ log-uniform on [1e-3, 0.1]
        dt0 = torch.exp(uniform(math.log(1e-3), math.log(0.1), n, nh))
        return {
            "norm": zeros(n, d),
            "in_proj": stacked((d, in_dim), std, path + ("in_proj",)),
            "conv_w": stacked((conv_dim, m.d_conv), std, path + ("conv_w",)),
            "A_log": torch.log(uniform(1.0, 16.0, n, nh)),
            "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
            "D": torch.ones((n, nh), dtype=torch.float32, device=dev),
            "gnorm": zeros(n, di),
            "out_proj": stacked((di, d), out_std, path + ("out_proj",)),
        }

    def init_mlp(path):
        return {
            "norm": zeros(n, d),
            "w_gate": stacked((d, ff), std, path + ("w_gate",)),
            "w_in": stacked((d, ff), std, path + ("w_in",)),
            "w_out": stacked((ff, d), out_std, path + ("w_out",)),
        }

    def init_moe(path):
        E, ffe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        return {
            "norm": zeros(n, d),
            "router": stacked((d, E), std, path + ("router",)),
            "w_gate": stacked((E, d, ffe), std, path + ("w_gate",)),
            "w_in": stacked((E, d, ffe), std, path + ("w_in",)),
            "w_out": stacked((E, ffe, d), out_std, path + ("w_out",)),
        }

    params: Params = {}
    if cfg.embed_inputs:  # an encoder fed embeddings has no table
        params["embed"] = normal((cfg.vocab_size, d), std, ("embed",))
    blocks = {}
    for i, spec in enumerate(cfg.block_pattern):
        lp = {}
        path = ("blocks", f"layer_{i}")
        if spec.mixer == "attn":
            lp["attn"] = init_attn(path + ("attn",))
        else:
            lp["mamba"] = init_mamba(path + ("mamba",))
        if spec.ffn == "mlp":
            lp["mlp"] = init_mlp(path + ("mlp",))
        elif spec.ffn == "moe":
            lp["moe"] = init_moe(path + ("moe",))
        blocks[f"layer_{i}"] = lp
    params["blocks"] = blocks
    params["final_norm"] = zeros(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), std, ("lm_head",))
    return params


# ---------------------------------------------------------------------------
# int8 serving weights
# ---------------------------------------------------------------------------

_QUANT_LEAVES = {
    "wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out",
    "in_proj", "out_proj", "router", "conv_w",
}


def quantize_params(params: Params) -> Params:
    """Per-output-channel symmetric int8 for the block weight matrices.

    Counterpart of ``repro.models.model.quantize_params``: each leaf
    named in ``_QUANT_LEAVES`` with two dims or more becomes ``{"q8":
    int8, "sc": float32}``, with the scale over the input dim (-2);
    norms, the Mamba2 float32 leaves, the embedding and the LM head keep
    their dtype.  A stacked leaf is quantized one block at a time (the
    reduction never crosses the block axis), so no float32 copy of a
    whole stack is held: llama's ``w_gate`` would take 7.5 GB."""

    def leaf(x: torch.Tensor):
        if x.dim() < 3:
            q, sc = L.quantize(x, -2)
            return {"q8": q, "sc": sc}
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        sc = torch.empty((*x.shape[:-2], x.shape[-1]), dtype=torch.float32,
                         device=x.device)
        for i in range(x.shape[0]):
            q[i], sc[i] = L.quantize(x[i], -2)
        return {"q8": q, "sc": sc}

    def visit(name, x):
        if isinstance(x, dict):
            return {k: visit(k, v) for k, v in x.items()}
        if name in _QUANT_LEAVES and x.dim() >= 2:
            return leaf(x)
        return x

    return visit(None, params)


def _dequant_tree(t, dt: torch.dtype):
    """A block's tree with every ``{"q8", "sc"}`` leaf dequantized to
    ``dt``: the codes times the scale broadcast over the input dim, in
    float32, then cast (the reference's rounding; :func:`L.dequantize`
    does it in one pass)."""
    if isinstance(t, dict):
        if set(t) == {"q8", "sc"}:
            return L.dequantize(t["q8"], t["sc"].float().unsqueeze(-2), dt)
        return {k: _dequant_tree(v, dt) for k, v in t.items()}
    return t


def params_quantized(params: Params) -> bool:
    """Whether the tree holds any quantized (``q8``) leaf."""
    if isinstance(params, dict):
        return "q8" in params or any(params_quantized(v)
                                     for v in params.values())
    return False


def _block(params: Params, cfg: ModelConfig, blk: int):
    """Block ``blk`` of the stacked tree, dequantized where it holds
    int8 leaves, as every JAX entry point does at block entry."""
    return _dequant_tree(_index(params["blocks"], blk), _dtype(cfg))


# ---------------------------------------------------------------------------
# Sub-layer applications
# ---------------------------------------------------------------------------


def _attn_qkv(p, cfg: ModelConfig, h: torch.Tensor):
    """q, K and V at this rank's heads, read off the local weights."""
    B, S, _ = h.shape
    q = (h @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    k = (h @ p["wk"]).reshape(B, S, -1, cfg.head_dim)
    v = (h @ p["wv"]).reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _row_parallel(y: torch.Tensor, w: torch.Tensor, full_in: int):
    """``y = h @ w``.  Where ``w`` holds a shard of its input dim (``wo``,
    ``w_out`` on a slice), ``y`` is this rank's partial sum: add the
    other ranks' over ``"model"``."""
    return ctx.reduce_model(y) if w.shape[-2] < full_in else y


def _attend(fn, cfg: ModelConfig, q, k, v, *rest, **kw):
    """``fn``, a decode-attention wrapper, on this rank's heads (dim
    ``ndim - 2`` of q): its sharded branch when the layer's heads are
    split over the active mesh, else the unsharded call."""
    if q.shape[-2] == cfg.n_heads:
        return fn(q, k, v, *rest, **kw)
    return on_local_heads(fn, q, k, v, *rest, mesh=ctx.current_mesh(),
                          axis=ctx.MODEL_AXIS, **kw)


def _attn_full(p, cfg: ModelConfig, spec: LayerSpec, x, positions, lengths,
               plain: bool):
    """Full-sequence attention. Returns (residual_out, (k, v)).  Query and
    key positions are ``0..S-1``; ``lengths`` (B,) int32 masks keys past
    each row's prompt, as ``kv_valid`` does in the JAX model."""
    B, S, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(p, cfg, h)
    if cfg.use_rope:
        sin, cos = L.rope_sincos(positions, cfg.head_dim, cfg.rope_theta)
        q = L.apply_rope(q, sin, cos)
        k = L.apply_rope(k, sin, cos)
    valid = None if lengths is None else positions < lengths[:, None]
    if plain and spec.window is not None and cfg.causal:
        o = L.sliding_attention(q, k, v, window=spec.window,
                                softcap=cfg.attn_softcap, kv_valid=valid)
    elif plain:
        o = L.chunked_attention(
            q, k, v, causal=cfg.causal, window=spec.window,
            softcap=cfg.attn_softcap, q_positions=positions,
            kv_positions=positions, kv_valid=valid,
        )
    else:
        o = flash_attention(
            q, k, v, causal=cfg.causal, window=spec.window,
            softcap=cfg.attn_softcap, kv_len=lengths,
        )
    out = _row_parallel(o.reshape(B, S, -1) @ p["wo"], p["wo"], cfg.q_dim)
    return out, (k, v)


def _attn_decode(p, cfg: ModelConfig, spec: LayerSpec, x, entry, blk: int,
                 q_pos, write_slot, plain: bool):
    """One-token attention against block ``blk`` of a ring-cache entry.

    x: (B, d); entry holds k/v (n, B, C, Hkv, Dh) and pos (n, B, C);
    q_pos: (B,) int32 absolute position of the new token; write_slot:
    (B,).  The new K/V and position are written into the cache **in
    place** (JAX returns a new cache; here the ring buffers are reused);
    an int8 ring also takes the new scales.  Returns the residual
    output."""
    B, _ = x.shape
    h = L.rms_norm(x[:, None, :], p["norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(p, cfg, h)  # (B, 1, H, Dh)
    if cfg.use_rope:
        sin, cos = L.rope_sincos(q_pos[:, None], cfg.head_dim, cfg.rope_theta)
        q = L.apply_rope(q, sin, cos)
        k = L.apply_rope(k, sin, cos)
    bidx = torch.arange(B, device=x.device)
    slot = write_slot.long()
    k_cache, v_cache, pos = entry["k"][blk], entry["v"][blk], entry["pos"][blk]
    if cfg.kv_dtype == "int8":
        # write the new position's codes and scales, then attend over the
        # whole ring dequantized, as the reference does
        for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
            codes, sc = quantize_kv(new)
            entry[name][blk][bidx, slot] = codes
            entry[f"{name}_sc"][blk][bidx, slot] = sc
        k_cache = dequantize_kv(k_cache, entry["k_sc"][blk], q.dtype)
        v_cache = dequantize_kv(v_cache, entry["v_sc"][blk], q.dtype)
    else:
        k_cache[bidx, slot] = k[:, 0]
        v_cache[bidx, slot] = v[:, 0]
    pos[bidx, slot] = q_pos
    kw = dict(window=spec.window, softcap=cfg.attn_softcap)
    if plain:
        o = L.decode_attention(q[:, 0], k_cache, v_cache, pos, q_pos, **kw)
    else:
        o = _attend(decode_attention, cfg, q[:, 0], k_cache, v_cache, pos,
                    q_pos, **kw)
    return _row_parallel(o.reshape(B, -1) @ p["wo"], p["wo"], cfg.q_dim)


def _mamba_inner_split(p, cfg: ModelConfig, h):
    m = cfg.mamba
    d = cfg.d_model
    di = m.d_inner(d)
    nh = m.n_heads(d)
    N = m.d_state
    proj = h @ p["in_proj"]
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * N]
    dt_raw = proj[..., di + di + 2 * N:]
    return z, xbc, dt_raw, di, nh, N


def _mamba_full(p, cfg: ModelConfig, x, valid, plain: bool):
    """Full-sequence Mamba2 (SSD).  ``valid`` (B, S) bool, or None for
    every position.

    Returns (residual_out, (final_ssm_state, conv_tail)) where conv_tail
    is the last (d_conv-1) *pre-conv* features per row — the decode-time
    conv ring state.  The scan runs in the ``ssd_scan`` kernel, or in
    ``L.ssd_chunked`` with ``plain``."""
    m = cfg.mamba
    B, S, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt_raw, di, nh, N = _mamba_inner_split(p, cfg, h)
    if valid is not None:  # zero padded positions so state is unpolluted
        xbc = xbc * valid[..., None].to(xbc.dtype)
        lengths = valid.sum(dim=-1)  # (B,)
    else:
        lengths = torch.full((B,), S, device=x.device)
    # conv tail state: last (K-1) pre-conv inputs per row (zeros if short)
    K = m.d_conv
    tail_pos = lengths[:, None] - (K - 1) \
        + torch.arange(K - 1, device=x.device)[None, :]  # (B, K-1)
    tail = xbc[torch.arange(B, device=x.device)[:, None],
               torch.clamp(tail_pos, 0, S - 1)]
    conv_tail = torch.where((tail_pos >= 0)[..., None], tail,
                            torch.zeros_like(tail))
    xbc = F.silu(L.causal_conv1d(xbc, p["conv_w"]))
    xs = xbc[..., :di].reshape(B, S, nh, m.head_dim)
    Bm = xbc[..., di: di + N]
    Cm = xbc[..., di + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, nh)
    if valid is not None:
        dt = dt * valid[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"])
    scan = L.ssd_chunked if plain else ssd_scan
    y, state = scan(xs, dt, A, Bm, Cm, chunk=m.chunk)
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, di)
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), p["gnorm"],
                   cfg.norm_eps)
    return y @ p["out_proj"], (state, conv_tail)


def _mamba_decode(p, cfg: ModelConfig, x, entry, blk: int):
    """One-token Mamba2 step against block ``blk`` of a recurrent cache
    entry (conv (n, B, K-1, conv_dim), ssm (n, B, H, P, N)), updated in
    place.  x: (B, d); returns the residual output."""
    m = cfg.mamba
    B, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt_raw, di, nh, N = _mamba_inner_split(p, cfg, h)
    xbc_c, conv_state = L.conv_step(xbc, entry["conv"][blk], p["conv_w"])
    entry["conv"][blk] = conv_state
    xbc_c = F.silu(xbc_c)
    xs = xbc_c[..., :di].reshape(B, nh, m.head_dim)
    Bm = xbc_c[..., di: di + N]
    Cm = xbc_c[..., di + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    y, ssm_state = L.ssd_decode_step(xs, dt, A, Bm, Cm, entry["ssm"][blk])
    entry["ssm"][blk] = ssm_state
    y = y + xs * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(B, di)
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), p["gnorm"],
                   cfg.norm_eps)
    return y @ p["out_proj"]


def _ffn(lp, cfg: ModelConfig, x):
    """MLP or MoE FFN on (B, S, d) (or (B, d)).  Returns (out,
    moe_aux | None); the MoE routes every row of x, pad rows included,
    as the JAX model does."""
    if "mlp" in lp:
        p = lp["mlp"]
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        return _row_parallel(
            L.glu_mlp(h, p["w_gate"], p["w_in"], p["w_out"], cfg.act),
            p["w_out"], cfg.d_ff), None
    p = lp["moe"]
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    out, aux = L.moe_ffn_sorted(
        h.reshape(-1, h.shape[-1]), p["router"], p["w_gate"], p["w_in"],
        p["w_out"], top_k=cfg.moe.top_k, act=cfg.act,
        capacity_factor=cfg.moe.capacity_factor,
        dispatch_dtype=cfg.moe.dispatch_dtype,
    )
    return out.reshape(h.shape), aux


def _moe_loss(cfg: ModelConfig, aux) -> torch.Tensor:
    """One MoE layer's load-balancing loss, E * sum(f * me), with f the
    share of entries routed to each expert."""
    f = aux["load"].float()
    f = f / torch.clamp(f.sum(), min=1.0)
    return cfg.moe.num_experts * torch.sum(f * aux["me"])


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Token embeddings.  A vocabulary shard (a slice's ``embed``) gives
    0 for the rows it does not hold and the sum over ``"model"`` fills
    them in: exactly the unsharded lookup."""
    E = params["embed"]
    ids = tokens.long()
    if E.shape[0] == cfg.vocab_size:
        return E[ids]
    n = E.shape[0]
    ids = ids - ctx.model_rank() * n
    hit = (ids >= 0) & (ids < n)
    x = E[torch.where(hit, ids, 0)] * hit[..., None].to(E.dtype)
    return ctx.reduce_model(x)


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------


def _ring_take(S: int, cap: int, lengths):
    """Where a ring of ``cap`` slots keeps a prompt of S positions (rows
    ``lengths`` long): None for the identity layout (cap >= S: position
    i at slot i), else the (B, cap) positions it keeps, the last ``cap``
    of each row, which sit at slot ``position % cap``."""
    if cap >= S:
        return None
    start = torch.clamp(lengths.long() - cap, min=0)  # (B,)
    return start[:, None] + torch.arange(cap, device=lengths.device)[None]


def _ring_write(cfg: ModelConfig, entry, blk: int, k, v, lengths) -> None:
    """A prefill's (B, S, Hkv, Dh) K/V of block ``blk`` into its ring,
    in :func:`_ring_take`'s layout; an int8 ring takes the codes and, at
    the same slots, their scales."""
    B, S = k.shape[:2]
    leaves = {"k": k, "v": v}
    if cfg.kv_dtype == "int8":
        leaves = {}
        for name, full in (("k", k), ("v", v)):
            leaves[name], leaves[f"{name}_sc"] = quantize_kv(full)
    src = _ring_take(S, entry["k"].shape[2], lengths)
    for name, full in leaves.items():
        if src is None:
            entry[name][blk, :, :S] = full
        else:
            bidx = torch.arange(B, device=k.device)[:, None]
            entry[name][blk][bidx, src % src.shape[1]] = full[bidx, src]


def _run_blocks(params, cfg: ModelConfig, x, positions, lengths, cache,
                plain: bool):
    """The JAX scan over blocks, as a loop.  With ``cache`` (from
    :func:`init_cache`) each block's K/V is written into its ring as it
    is produced (:func:`_ring_take`'s layout), and each Mamba block's
    final state and conv tail into its entry.  Returns (x, moe_loss)."""
    valid = None if lengths is None else positions < lengths[:, None]
    moe_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in range(cfg.n_blocks):
        bp = _block(params, cfg, blk)
        for i, spec in enumerate(cfg.block_pattern):
            lp = bp[f"layer_{i}"]
            entry = None if cache is None else cache[f"layer_{i}"]
            if spec.mixer == "attn":
                out, (k, v) = _attn_full(lp["attn"], cfg, spec, x, positions,
                                         lengths, plain)
                if entry is not None:
                    _ring_write(cfg, entry, blk, k, v, lengths)
            else:
                out, (ssm, conv) = _mamba_full(lp["mamba"], cfg, x, valid,
                                               plain)
                if entry is not None:
                    entry["ssm"][blk] = ssm
                    entry["conv"][blk] = conv
            x = x + out
            if spec.ffn != "none":
                out, aux = _ffn(lp, cfg, x)
                x = x + out
                if aux is not None:
                    moe_loss = moe_loss + _moe_loss(cfg, aux)
    return x, moe_loss


def _inputs(params: Params, cfg: ModelConfig, tokens, inputs_embeds):
    """The first block's input: token embeddings, or for an encoder fed
    embeddings (``embed_inputs=False``) ``inputs_embeds`` cast to the
    model dtype."""
    if cfg.embed_inputs:
        return _embed(params, cfg, tokens)
    if inputs_embeds is None:
        raise ValueError(f"model '{cfg.name}' takes inputs_embeds "
                         "(B, S, d_model), not token ids")
    return inputs_embeds.to(_dtype(cfg))


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None,
            plain_attention: bool = False):
    """Returns (hidden (B,S,d), moe_aux_loss) for tokens (B, S), or for
    ``inputs_embeds`` (B, S, d) where the config takes embeddings.
    ``lengths`` (B,) masks keys at and past each row's length, as the
    reference's ``valid = arange(S) < lengths`` does.
    ``plain_attention`` runs every mixer's plain layer (attention and
    the SSD scan) instead of its kernel."""
    check_supported(cfg)
    x = _inputs(params, cfg, tokens, inputs_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int32)
    x, moe_loss = _run_blocks(params, cfg, x, positions, lengths, None,
                              plain_attention)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, moe_loss


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor):
    """Logits in float32 (the JAX model's ``preferred_element_type``):
    at a 128k vocabulary, bf16 logits make argmax ties common.  A
    vocabulary shard's logits are gathered over ``"model"``, so every
    rank holds the full row.

    On the card a bf16 head multiplies bf16 hidden states into float32
    (``aten::mm.dtype``), as the JAX model's ``preferred_element_type``
    does, with no float32 copy of the head; elsewhere both operands are
    upcast."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if hidden.is_cuda and head.dtype == hidden.dtype == torch.bfloat16:
        logits = torch.mm(hidden.reshape(-1, hidden.shape[-1]), head,
                          out_dtype=torch.float32)
        logits = logits.reshape(*hidden.shape[:-1], head.shape[-1])
    else:
        logits = hidden.float() @ head.float()
    if head.shape[-1] < cfg.vocab_size:
        logits = ctx.gather_model(logits, dim=-1)
    if cfg.logit_softcap is not None:
        logits = L._softcap(logits, cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Serving: prefill and decode over the dense ring cache
# ---------------------------------------------------------------------------


def cache_capacity(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.window is not None:
        return min(max_len, spec.window)
    return max_len


def _kv_heads(cfg: ModelConfig) -> int:
    """KV heads a rank holds: its share when the heads divide the active
    mesh's ``"model"`` axis (the sharding rules split them then), all of
    them otherwise."""
    mesh = ctx.current_mesh()
    if ctx.heads_shardable(mesh, cfg.n_heads, cfg.n_kv_heads):
        return cfg.n_kv_heads // ctx.model_width(mesh)
    return cfg.n_kv_heads


def _kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.int8 if cfg.kv_dtype == "int8" else _dtype(cfg)


def quantize_kv(x: torch.Tensor):
    """Per-(position, head) symmetric int8: x (..., Dh) -> (codes int8,
    scale float32 (...)), the reference's arithmetic."""
    return L.quantize(x, -1)


def dequantize_kv(q: torch.Tensor, sc: torch.Tensor,
                  dt: torch.dtype) -> torch.Tensor:
    return L.dequantize(q, sc[..., None], dt)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> PyTree:
    """Empty decode cache (zeros; slot_pos=-1 marks empty slots).  An
    attention layer holds a K/V ring (at this rank's kv heads under a
    mesh context; int8 codes plus float32 ``k_sc``/``v_sc`` per
    position and head with ``kv_dtype="int8"``), a Mamba layer its conv
    tail (model dtype) and SSM state (float32)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    m = cfg.mamba
    n = cfg.n_blocks
    cache = {}
    for i, spec in enumerate(cfg.block_pattern):
        if spec.mixer == "attn":
            cap = cache_capacity(cfg, spec, max_len)
            shape = (n, batch, cap, _kv_heads(cfg), cfg.head_dim)
            entry = {
                "k": torch.zeros(shape, dtype=_kv_store_dtype(cfg),
                                 device=dev),
                "v": torch.zeros(shape, dtype=_kv_store_dtype(cfg),
                                 device=dev),
                "pos": torch.full((n, batch, cap), -1, dtype=torch.int32,
                                  device=dev),
            }
            if cfg.kv_dtype == "int8":
                for name in ("k_sc", "v_sc"):
                    entry[name] = torch.zeros(shape[:-1],
                                              dtype=torch.float32,
                                              device=dev)
        else:
            conv_dim = m.d_inner(cfg.d_model) + 2 * m.d_state
            entry = {
                "conv": torch.zeros((n, batch, m.d_conv - 1, conv_dim),
                                    dtype=dt, device=dev),
                "ssm": torch.zeros((n, batch, m.n_heads(cfg.d_model),
                                    m.head_dim, m.d_state),
                                   dtype=torch.float32, device=dev),
            }
        cache[f"layer_{i}"] = entry
    return cache


def prefill(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor], lengths: torch.Tensor,
            inputs_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, plain_attention: bool = False):
    """Run the prompt and build the decode cache.

    tokens (B, S) left-aligned (or ``inputs_embeds`` (B, S, d) where the
    config takes embeddings), lengths (B,).  Returns (last_logits (B, V)
    float32, cache); ``max_len`` is the cache capacity (defaults to S).
    Attention runs on the unquantized K/V; an int8 ring stores their
    codes and scales.  ``plain_attention`` runs every mixer's plain
    layer (attention and the SSD scan) instead of its kernel.
    """
    check_supported(cfg)
    x = _inputs(params, cfg, tokens, inputs_embeds)
    B, S = x.shape[:2]
    max_len = max_len or S
    dev = x.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    pos_row = torch.arange(S, device=dev, dtype=torch.int32)
    positions = pos_row.expand(B, S)
    cache = init_cache(cfg, B, max_len, dev)
    x, _ = _run_blocks(params, cfg, x, positions, lengths, cache,
                       plain_attention)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    # logits at the last valid position of each row
    last = torch.clamp(lengths.long() - 1, min=0)
    logits = lm_logits(params, cfg, x[torch.arange(B, device=dev), last])
    for entry in cache.values():
        if "pos" not in entry:  # Mamba entries
            continue
        src = _ring_take(S, entry["pos"].shape[2], lengths)
        if src is None:  # identity layout: slots >= S stay empty
            pos = torch.where(pos_row[None] < lengths[:, None],
                              pos_row[None], -1)
            entry["pos"][:, :, :S] = pos.to(torch.int32)
        else:  # the last cap positions, -1 past each row's length
            pos = torch.where(src < lengths[:, None], src, -1)
            entry["pos"][:] = pos.to(torch.int32)
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: PyTree, lengths: torch.Tensor,
                plain_attention: bool = False):
    """One decode iteration: tokens (B,), lengths (B,) = the new token's
    position.  Returns (logits (B, V) float32, cache); the cache is
    updated in place and returned for the JAX call shape."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)  # (B, d)
    q_pos = lengths.to(device=x.device, dtype=torch.int32)
    for blk in range(cfg.n_blocks):
        bp = _block(params, cfg, blk)
        for i, spec in enumerate(cfg.block_pattern):
            lp = bp[f"layer_{i}"]
            entry = cache[f"layer_{i}"]
            if spec.mixer == "attn":
                write_slot = q_pos % entry["k"].shape[2]
                x = x + _attn_decode(lp["attn"], cfg, spec, x, entry, blk,
                                     q_pos, write_slot, plain_attention)
            else:
                x = x + _mamba_decode(lp["mamba"], cfg, x, entry, blk)
            if spec.ffn != "none":
                x = x + _ffn(lp, cfg, x)[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Greedy serving entry points (argmax on the device)
# ---------------------------------------------------------------------------
# The serving backend decodes greedily, so the host only ever needs the
# argmax ids: they stay on the device as the next step's input, and the
# host reads them when it emits tokens (repro_torch.serving.realengine).


def prefill_greedy(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   lengths: torch.Tensor, max_len: Optional[int] = None):
    """:func:`prefill` returning (first token ids (B,) int32, cache)."""
    logits, cache = prefill(params, cfg, tokens, lengths, max_len=max_len)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_step_greedy(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       cache: PyTree, lengths: torch.Tensor):
    """:func:`decode_step` returning (next token ids (B,) int32, cache)."""
    logits, cache = decode_step(params, cfg, tokens, cache, lengths)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


# ---------------------------------------------------------------------------
# Paged serving: KV lives in pool pages, requests carry block tables
# ---------------------------------------------------------------------------


def _check_paged(cfg: ModelConfig) -> None:
    """Reject configs the paged cache cannot serve.  Raises ``ValueError``
    (never ``assert``), as the JAX model does."""
    if cfg.has_mamba:
        raise ValueError(
            f"model '{cfg.name}': paged KV covers attention caches only; "
            "recurrent (Mamba) state is constant-size per request and "
            "cannot resume mid-sequence from shared prefix pages — serve "
            "hybrid models with paged=False"
        )
    if cfg.kv_dtype == "int8":
        raise ValueError(
            f"model '{cfg.name}': paged cache does not carry int8 KV "
            "scales yet — set kv_dtype to a float dtype or serve with "
            "paged=False (which supports int8 KV)"
        )


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device: DeviceLike = None) -> PyTree:
    """Paged decode cache: per attention layer, a pool of
    ``(n_blocks, num_pages + 1, page_size, Hkv, Dh)`` K/V pages shared by
    every resident sequence (at this rank's kv heads under a mesh
    context).  Token position ``i`` of a sequence lives in
    ``block_table[i // page_size]`` at offset ``i % page_size``.  The
    extra page at index ``num_pages`` is a write scratch: masked and
    padded scatters land there instead of on live pages."""
    _check_paged(cfg)
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_blocks, num_pages + 1, page_size, _kv_heads(cfg),
             cfg.head_dim)
    return {
        f"layer_{i}": {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        }
        for i in range(len(cfg.block_pattern))
    }


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor):
    """(P+1, ps, H, D) pages x (B, Pmax) tables -> (B, Pmax*ps, H, D)
    dense per-sequence copy (-1 table entries clamp to page 0; callers
    mask by length)."""
    B, Pmax = block_tables.shape
    g = pages[torch.clamp(block_tables.long(), min=0)]  # (B, Pmax, ps, H, D)
    return g.reshape(B, Pmax * pages.shape[1], *pages.shape[2:])


def _pool_geometry(cache: PyTree):
    """(scratch page id, page size) of a paged cache."""
    leaf = cache["layer_0"]["k"]  # (n_blocks, P+1, ps, Hkv, Dh)
    return leaf.shape[1] - 1, leaf.shape[2]


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, ctx_lens: torch.Tensor,
                  block_tables: torch.Tensor, cache: PyTree,
                  plain_attention: bool = False):
    """Prefill that writes straight into pool pages.

    tokens (B, S) are the NEW suffix tokens, left-aligned; lengths (B,)
    their count; ctx_lens (B,) the resident prefix (a radix hit, page
    aligned, already in the pool), which is not recomputed; block_tables
    (B, Pmax) cover ctx + new, -1 padded.  New K/V scatters into the pages
    the table assigns to positions ``ctx .. ctx+len`` (pad rows to the
    scratch page).  Returns ``(last_logits (B, V) float32, cache)``.

    The kernel path scatters first, then gathers the table into a dense
    ``(B, Pmax*ps)`` view and runs ``flash_attention`` with query row i at
    position ``ctx + i`` and ``kv_len = ctx + len``: the keys of the JAX
    model's concat of prefix pages and new K/V, summed in another order.
    Radix matches are whole pages, so the scatter only writes fresh pages
    and the prefix reads the same either side of it.
    ``plain_attention=True`` runs the JAX model's concat through
    ``L.chunked_attention``."""
    _check_paged(cfg)
    check_supported(cfg)
    dev = tokens.device
    B, S = tokens.shape
    scratch, ps = _pool_geometry(cache)
    Pmax = block_tables.shape[1]
    C = Pmax * ps
    lengths = lengths.to(device=dev, dtype=torch.int32)
    ctx_lens = ctx_lens.to(device=dev, dtype=torch.int32)
    bt = block_tables.to(device=dev, dtype=torch.int32)
    x = _embed(params, cfg, tokens)
    pos_row = torch.arange(S, device=dev, dtype=torch.int32)
    positions = ctx_lens[:, None] + pos_row[None]  # (B, S) absolute
    valid = pos_row[None] < lengths[:, None]
    bidx = torch.arange(B, device=dev)[:, None]
    # new token i of row b -> page bt[b, pos // ps], offset pos % ps
    pid = bt[bidx, torch.clamp(positions // ps, max=Pmax - 1).long()]
    pid = torch.where(valid & (pid >= 0), pid, scratch).long()
    off = (positions % ps).long()
    if plain_attention:
        ctx_pos = torch.arange(C, device=dev, dtype=torch.int32).expand(B, C)
        kv_pos = torch.cat([ctx_pos, positions], dim=1)
        kv_valid = torch.cat([ctx_pos < ctx_lens[:, None], valid], dim=1)
    kv_len = ctx_lens + lengths
    for blk in range(cfg.n_blocks):
        bp = _block(params, cfg, blk)
        for i, spec in enumerate(cfg.block_pattern):
            lp = bp[f"layer_{i}"]
            entry = cache[f"layer_{i}"]
            kp, vp = entry["k"][blk], entry["v"][blk]
            h = L.rms_norm(x, lp["attn"]["norm"], cfg.norm_eps)
            q, k, v = _attn_qkv(lp["attn"], cfg, h)
            if cfg.use_rope:
                sin, cos = L.rope_sincos(positions, cfg.head_dim,
                                         cfg.rope_theta)
                q = L.apply_rope(q, sin, cos)
                k = L.apply_rope(k, sin, cos)
            kp[pid, off] = k
            vp[pid, off] = v
            kg, vg = _gather_pages(kp, bt), _gather_pages(vp, bt)
            if plain_attention:
                # the JAX model's span: resident prefix pages (kv_valid
                # masks the table past ctx), then the new K/V
                o = L.chunked_attention(
                    q, torch.cat([kg, k], dim=1), torch.cat([vg, v], dim=1),
                    causal=True, window=spec.window,
                    softcap=cfg.attn_softcap, q_positions=positions,
                    kv_positions=kv_pos, kv_valid=kv_valid,
                    q_chunk=S, k_chunk=C + S,
                )
            else:
                o = flash_attention(
                    q, kg, vg, causal=True, window=spec.window,
                    softcap=cfg.attn_softcap, kv_len=kv_len,
                    q_start=ctx_lens,
                )
            wo = lp["attn"]["wo"]
            x = x + _row_parallel(o.reshape(B, S, -1) @ wo, wo, cfg.q_dim)
            if spec.ffn != "none":
                x = x + _ffn(lp, cfg, x)[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = torch.clamp(lengths.long() - 1, min=0)
    logits = lm_logits(params, cfg, x[torch.arange(B, device=dev), last])
    return logits, cache


def verify_step_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: PyTree, lengths: torch.Tensor,
                      block_tables: torch.Tensor,
                      plain_attention: bool = False):
    """Speculative verify: forward ``T = k + 1`` tokens per sequence in
    one pass over the paged pool.

    tokens (B, T): the pending token and k draft proposals; lengths (B,)
    the resident tokens BEFORE this step; block_tables (B, Pmax) must
    cover ``lengths + T``.  K/V of all T rows scatters into the pool
    first (a row past the table's coverage goes to the scratch page,
    never to the clamped last page), then attention is causal within the
    window (row j sees positions ``<= lengths + j``).  Returns
    ``(logits (B, T, V) float32, cache)``; ``T == 1`` is
    :func:`decode_step_paged`.  Rollback of rejected rows is the caller's
    page bookkeeping."""
    _check_paged(cfg)
    check_supported(cfg)
    dev = tokens.device
    B, T = tokens.shape
    scratch, ps = _pool_geometry(cache)
    Pmax = block_tables.shape[1]
    C = Pmax * ps
    lengths = lengths.to(device=dev, dtype=torch.int32)
    bt = block_tables.to(device=dev, dtype=torch.int32)
    x = _embed(params, cfg, tokens)  # (B, T, d)
    positions = lengths[:, None] + torch.arange(T, device=dev,
                                                dtype=torch.int32)[None]
    bidx = torch.arange(B, device=dev)[:, None]
    pid = bt[bidx, torch.clamp(positions // ps, max=Pmax - 1).long()]
    pid = torch.where((pid >= 0) & (positions < C), pid, scratch).long()
    off = (positions % ps).long()
    if plain_attention:
        slot_pos = torch.arange(C, device=dev, dtype=torch.int32).expand(B, C)
    total = lengths + T  # valid tokens incl. the T new ones
    for blk in range(cfg.n_blocks):
        bp = _block(params, cfg, blk)
        for i, spec in enumerate(cfg.block_pattern):
            lp = bp[f"layer_{i}"]
            entry = cache[f"layer_{i}"]
            kp, vp = entry["k"][blk], entry["v"][blk]
            h = L.rms_norm(x, lp["attn"]["norm"], cfg.norm_eps)
            q, k, v = _attn_qkv(lp["attn"], cfg, h)  # (B, T, H, Dh)
            if cfg.use_rope:
                sin, cos = L.rope_sincos(positions, cfg.head_dim,
                                         cfg.rope_theta)
                q = L.apply_rope(q, sin, cos)
                k = L.apply_rope(k, sin, cos)
            kp[pid, off] = k
            vp[pid, off] = v
            if plain_attention:
                o = L.verify_attention(
                    q, _gather_pages(kp, bt), _gather_pages(vp, bt),
                    slot_pos, positions, window=spec.window,
                    softcap=cfg.attn_softcap,
                )
            elif T == 1:
                o = _attend(paged_decode_attention, cfg, q[:, 0], kp, vp, bt,
                            total, window=spec.window,
                            softcap=cfg.attn_softcap)[:, None]
            else:
                o = _attend(paged_verify_attention, cfg, q, kp, vp, bt,
                            total, window=spec.window,
                            softcap=cfg.attn_softcap)
            wo = lp["attn"]["wo"]
            x = x + _row_parallel(o.reshape(B, T, -1) @ wo, wo, cfg.q_dim)
            if spec.ffn != "none":
                x = x + _ffn(lp, cfg, x)[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, cfg, x), cache


def decode_step_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: PyTree, lengths: torch.Tensor,
                      block_tables: torch.Tensor,
                      plain_attention: bool = False):
    """One decode iteration over the paged pool: tokens (B,), lengths (B,)
    = resident tokens = the new token's position.  The ``T == 1`` call of
    :func:`verify_step_paged`; returns ``(logits (B, V), cache)``."""
    logits, cache = verify_step_paged(params, cfg, tokens[:, None], cache,
                                      lengths, block_tables,
                                      plain_attention=plain_attention)
    return logits[:, 0], cache


def draft_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: PyTree, lengths: torch.Tensor):
    """One greedy draft-model proposal step over the ring cache: returns
    ``(proposal ids (B,) int32, logits, cache)``."""
    logits, cache = decode_step(params, cfg, tokens, cache, lengths)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache


def accept_prefix(draft_tokens: torch.Tensor,
                  target_tokens: torch.Tensor) -> torch.Tensor:
    """Greedy accept-prefix: per sequence, the longest prefix where the
    k proposals (B, k) match the verify pass's argmaxes (B, k+1)
    (``target_tokens[:, a]`` is the bonus/correction token).  Returns
    (B,) int32 in ``[0, k]``."""
    match = (draft_tokens == target_tokens[:, :-1]).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)


def prefill_paged_greedy(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, lengths: torch.Tensor,
                         ctx_lens: torch.Tensor, block_tables: torch.Tensor,
                         cache: PyTree):
    """:func:`prefill_paged` returning (first token ids (B,) int32, cache)."""
    logits, cache = prefill_paged(params, cfg, tokens, lengths, ctx_lens,
                                  block_tables, cache)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_step_paged_greedy(params: Params, cfg: ModelConfig,
                             tokens: torch.Tensor, cache: PyTree,
                             lengths: torch.Tensor,
                             block_tables: torch.Tensor):
    """:func:`decode_step_paged` returning (next ids (B,) int32, cache)."""
    logits, cache = decode_step_paged(params, cfg, tokens, cache, lengths,
                                      block_tables)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def verify_step_paged_greedy(params: Params, cfg: ModelConfig,
                             tokens: torch.Tensor, cache: PyTree,
                             lengths: torch.Tensor,
                             block_tables: torch.Tensor):
    """:func:`verify_step_paged` returning (argmax ids (B, T) int32,
    cache)."""
    logits, cache = verify_step_paged(params, cfg, tokens, cache, lengths,
                                      block_tables)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache
