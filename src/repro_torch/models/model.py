"""Dense model of the port: init, forward, prefill and ring-cache decode.

Counterpart of ``repro/models/model.py`` for dense attention + MLP
configs (the llama family).  Parameters keep the stacked
``params["blocks"]`` layout with a leading ``n_blocks`` axis, so JAX
weights carry across leaf for leaf (:mod:`repro_torch.models.bridge`);
``lax.scan`` over blocks becomes a Python loop over that axis.

Where the JAX model calls ``L.chunked_attention`` and
``L.decode_attention``, this model calls the Hopper kernels' wrappers
(:mod:`repro_torch.kernels`), which take their plain PyTorch versions
for CPU tensors.  ``plain_attention=True`` runs the ported layers
instead, as the JAX model does — the replay oracle on the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

Params = Dict[str, Any]
PyTree = Any


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Reject what the dense slice of the port does not serve yet."""
    other = (cfg.has_mamba or cfg.moe is not None or not cfg.embed_inputs
             or any(s.mixer != "attn" or s.ffn != "mlp"
                    for s in cfg.block_pattern))
    if other:
        raise NotImplementedError(
            f"model '{cfg.name}': the port serves dense attention + MLP "
            "configs; MoE, Mamba2, hybrid and encoder models are ROADMAP "
            "queue 1, item 7"
        )
    if cfg.kv_dtype == "int8" or cfg.weight_dtype == "int8":
        raise NotImplementedError(
            f"model '{cfg.name}': int8 weights and KV are ROADMAP queue 1, "
            "item 6"
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
                device: DeviceLike = None) -> Params:
    """Random weights with the shapes, standard deviations and dtypes of
    ``repro.models.model.init_params``, drawn from ``generator`` (which
    lives on ``device``).  Stacked leaves fill block by block, so the
    float32 draw never holds more than one block's matrix."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n = cfg.n_blocks
    std = 0.02
    out_std = std / math.sqrt(2 * cfg.n_layers)

    def normal(shape, s):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * s).to(dt)

    def stacked(shape, s):
        out = torch.empty((n, *shape), dtype=dt, device=dev)
        for i in range(n):
            out[i] = normal(shape, s)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    params: Params = {"embed": normal((cfg.vocab_size, d), std)}
    blocks = {}
    for i, spec in enumerate(cfg.block_pattern):
        attn = {
            "norm": zeros(n, d),
            "wq": stacked((d, qd), std),
            "wk": stacked((d, kvd), std),
            "wv": stacked((d, kvd), std),
            "wo": stacked((qd, d), out_std),
        }
        if cfg.qk_norm:
            attn["q_norm"] = zeros(n, cfg.head_dim)
            attn["k_norm"] = zeros(n, cfg.head_dim)
        mlp = {
            "norm": zeros(n, d),
            "w_gate": stacked((d, ff), std),
            "w_in": stacked((d, ff), std),
            "w_out": stacked((ff, d), out_std),
        }
        blocks[f"layer_{i}"] = {"attn": attn, "mlp": mlp}
    params["blocks"] = blocks
    params["final_norm"] = zeros(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), std)
    return params


# ---------------------------------------------------------------------------
# Sub-layer applications
# ---------------------------------------------------------------------------


def _attn_qkv(p, cfg: ModelConfig, h: torch.Tensor):
    B, S, _ = h.shape
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


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
    if spec.window is not None and cfg.causal:
        raise NotImplementedError(
            "sliding-window attention is ROADMAP queue 1, item 7"
        )
    if plain:
        valid = None if lengths is None else positions < lengths[:, None]
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
    out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
    return out, (k, v)


def _attn_decode(p, cfg: ModelConfig, spec: LayerSpec, x, entry, blk: int,
                 q_pos, write_slot, plain: bool):
    """One-token attention against block ``blk`` of a ring-cache entry.

    x: (B, d); entry holds k/v (n, B, C, Hkv, Dh) and pos (n, B, C);
    q_pos: (B,) int32 absolute position of the new token; write_slot:
    (B,).  The new K/V and position are written into the cache **in
    place** (JAX returns a new cache; here the ring buffers are reused).
    Returns the residual output."""
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
    k_cache[bidx, slot] = k[:, 0]
    v_cache[bidx, slot] = v[:, 0]
    pos[bidx, slot] = q_pos
    attend = L.decode_attention if plain else decode_attention
    o = attend(q[:, 0], k_cache, v_cache, pos, q_pos,
               window=spec.window, softcap=cfg.attn_softcap)
    return o.reshape(B, cfg.q_dim) @ p["wo"]


def _ffn(lp, cfg: ModelConfig, x):
    p = lp["mlp"]
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    return L.glu_mlp(h, p["w_gate"], p["w_in"], p["w_out"], cfg.act)


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------


def _run_blocks(params, cfg: ModelConfig, x, positions, lengths, cache,
                plain: bool):
    """The JAX scan over blocks, as a loop.  With ``cache`` (from
    :func:`init_cache`, capacity >= S) each block's K/V is written into
    slots ``0..S-1`` as it is produced."""
    S = x.shape[1]
    for blk in range(cfg.n_blocks):
        bp = _index(params["blocks"], blk)
        for i, spec in enumerate(cfg.block_pattern):
            lp = bp[f"layer_{i}"]
            out, (k, v) = _attn_full(lp["attn"], cfg, spec, x, positions,
                                     lengths, plain)
            x = x + out
            if cache is not None:
                entry = cache[f"layer_{i}"]
                entry["k"][blk, :, :S] = k
                entry["v"][blk, :, :S] = v
            x = x + _ffn(lp, cfg, x)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            plain_attention: bool = False):
    """Returns (hidden (B,S,d), moe_aux_loss) for tokens (B, S)."""
    check_supported(cfg)
    x = params["embed"][tokens.long()]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _run_blocks(params, cfg, x, positions, None, None, plain_attention)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor):
    """Logits in float32 (the JAX model's ``preferred_element_type``):
    at a 128k vocabulary, bf16 logits make argmax ties common."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = hidden.float() @ head.float()
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> PyTree:
    """Empty decode cache (zeros; slot_pos=-1 marks empty slots)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n = cfg.n_blocks
    cache = {}
    for i, spec in enumerate(cfg.block_pattern):
        cap = cache_capacity(cfg, spec, max_len)
        shape = (n, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        cache[f"layer_{i}"] = {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.full((n, batch, cap), -1, dtype=torch.int32,
                              device=dev),
        }
    return cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, max_len: Optional[int] = None,
            plain_attention: bool = False):
    """Run the prompt and build the decode cache.

    tokens (B, S) left-aligned, lengths (B,).  Returns (last_logits (B, V)
    float32, cache); ``max_len`` is the cache capacity (defaults to S).
    """
    check_supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    for spec in cfg.block_pattern:
        if cache_capacity(cfg, spec, max_len) < S:
            raise NotImplementedError(
                "a ring cache smaller than the prompt (windowed configs) is "
                "ROADMAP queue 1, item 7"
            )
    dev = tokens.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    x = params["embed"][tokens.long()]
    pos_row = torch.arange(S, device=dev, dtype=torch.int32)
    positions = pos_row.expand(B, S)
    cache = init_cache(cfg, B, max_len, dev)
    x = _run_blocks(params, cfg, x, positions, lengths, cache,
                    plain_attention)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    # logits at the last valid position of each row
    last = torch.clamp(lengths.long() - 1, min=0)
    logits = lm_logits(params, cfg, x[torch.arange(B, device=dev), last])
    # identity ring layout (cap >= S): slots >= S stay empty
    pos = torch.where(pos_row[None] < lengths[:, None], pos_row[None], -1)
    for entry in cache.values():
        entry["pos"][:, :, :S] = pos.to(torch.int32)
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: PyTree, lengths: torch.Tensor,
                plain_attention: bool = False):
    """One decode iteration: tokens (B,), lengths (B,) = the new token's
    position.  Returns (logits (B, V) float32, cache); the cache is
    updated in place and returned for the JAX call shape."""
    x = params["embed"][tokens.long()]  # (B, d)
    q_pos = lengths.to(device=x.device, dtype=torch.int32)
    for blk in range(cfg.n_blocks):
        bp = _index(params["blocks"], blk)
        for i, spec in enumerate(cfg.block_pattern):
            lp = bp[f"layer_{i}"]
            entry = cache[f"layer_{i}"]
            write_slot = q_pos % entry["k"].shape[2]
            x = x + _attn_decode(lp["attn"], cfg, spec, x, entry, blk, q_pos,
                                 write_slot, plain_attention)
            x = x + _ffn(lp, cfg, x)
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
