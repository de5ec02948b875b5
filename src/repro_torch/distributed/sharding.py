"""Sharding rules of a serving slice: which dim of each leaf goes on the
``"model"`` axis, and the cut of a full tree into this rank's shards.

Counterpart of the serving subset of ``repro/distributed/sharding.py``
(the rule table, ``param_pspecs``, ``serving_cache_pspecs``,
``place_serving_state``).  A rule gives a leaf one placement on the
slice's ``"model"`` mesh dim, ``Shard(d)`` or ``Replicate()``: Megatron
tensor parallelism, with wq, wk, wv, w_gate and w_in column-parallel
(their output dim split), wo and w_out row-parallel (their input dim
split; the model sums their outputs over ``"model"``), embed and lm_head
split over the vocabulary.  A dim whose global size does not divide
the axis stays replicated (the JAX rule's ``_fits``).  The rule table
is the JAX one; its Mamba2 and MoE entries split nothing here, since
Mamba2 on a mesh raises and MoE is not served by the port yet.

One rule differs from the JAX package's in layout, not in mathematics.
GSPMD splits wq's columns whenever ``q_dim`` divides the axis and
inserts whatever collectives follow; the port computes attention on
local heads, so a layer's attention weights shard only when its heads do
(:func:`~repro_torch.distributed.context.heads_shardable`, the rule of
the decode-attention wrappers) and otherwise stay replicated, with its
KV cache: the wrappers' own fallback.

A slice's ``"data"`` axis has width 1, so the JAX rule's second,
FSDP-style dim over the data-parallel axes never fits and is left out,
as are the dry-run's ``fsdp_sp`` mode, ``batch_pspec`` and
``cache_pspecs``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed.context import (
    MODEL_AXIS,
    heads_shardable,
    model_width,
)

PyTree = Any


@dataclass(frozen=True)
class ShardingPolicy:
    """The rule engine's policy.  The JAX policy's fields choose the
    data-parallel axes and the dry-run's modes; a serving slice has one
    layout (Megatron tensor parallelism over :data:`MODEL_AXIS`), so
    this policy has none."""


def default_policy(mesh) -> ShardingPolicy:
    """The serving policy of ``mesh``: the same for every slice."""
    return ShardingPolicy()


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# name -> the dim (offset by +1 for stacked block leaves) placed on the
# model axis; None replicates
_PARAM_RULES = {
    "embed": 0,  # vocab
    "lm_head": 1,  # vocab
    "wq": 1,
    "wk": 1,
    "wv": 1,
    "wo": 0,
    "w_gate": 1,
    "w_in": 1,
    "w_out": 0,
    "router": None,
    "in_proj": 1,  # mamba
    "conv_w": 0,
    "out_proj": 0,
    "gnorm": None,
    "norm": None,
    "q_norm": None,
    "k_norm": None,
    "final_norm": None,
    "A_log": None,
    "dt_bias": None,
    "D": None,
}
_ATTN_WEIGHTS = frozenset({"wq", "wk", "wv", "wo"})


def _global_size(cfg, name: str):
    """The global size of a leaf's rule dim, which ``_fits`` is decided
    on, so that a full tree and this rank's shards get the same
    placements.  None for a leaf the port does not split (Mamba2 on a
    mesh raises before its weights are placed)."""
    return {
        "embed": cfg.vocab_size, "lm_head": cfg.vocab_size,
        "wq": cfg.q_dim, "wo": cfg.q_dim, "wk": cfg.kv_dim,
        "wv": cfg.kv_dim, "w_gate": cfg.d_ff, "w_in": cfg.d_ff,
        "w_out": cfg.d_ff,
    }.get(name)


def leaf_placement(cfg, path, mesh):
    """The placement on the model axis of the parameter at ``path``
    (its keys in the param tree): ``Shard(d)`` of the leaf, counting the
    leading ``n_blocks`` axis of a stacked block leaf, or
    ``Replicate()``.  It depends on the config and the path, not on the
    leaf's shape, so a draw is cut before the next one is made."""
    path = tuple(path)
    name = path[-1]
    if name == "sc":  # int8 weight scales: tiny, replicated
        return Replicate()
    if name == "q8":  # quantized weight: rules of the parent leaf
        name = path[-2]
        path = path[:-1]
    rule = _PARAM_RULES.get(name)
    size = _global_size(cfg, name)
    n = model_width(mesh)
    if rule is None or size is None or n < 2 or size % n:
        return Replicate()
    if "attn" in path and name in _ATTN_WEIGHTS and not heads_shardable(
            mesh, cfg.n_heads, cfg.n_kv_heads):
        return Replicate()
    return Shard(rule + (1 if "blocks" in path else 0))


def _map(fn: Callable, tree: PyTree, *rest: PyTree, path=()) -> PyTree:
    """``fn(path, leaf, *rest_leaves)`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def param_pspecs(cfg, param_tree: PyTree, mesh) -> PyTree:
    """Placement tree mirroring ``param_tree`` (full or this rank's
    shards: the placements are the same)."""
    return _map(lambda path, _: leaf_placement(cfg, path, mesh), param_tree)


# ---------------------------------------------------------------------------
# Serving caches
# ---------------------------------------------------------------------------


def kv_head_dim(name: str, ndim: int):
    """The kv-head dim of a serving cache leaf named ``name``: ``ndim -
    2`` for K/V (the dense ring ``(n, B, C, Hkv, Dh)`` and the paged pool
    ``(n, P+1, page, Hkv, Dh)``), ``ndim - 1`` for int8 ring scales
    ``(n, B, C, H)``, None for a leaf without heads (``pos``, a Mamba2
    conv tail or SSM state)."""
    if name in ("k", "v"):
        return ndim - 2
    if name in ("k_sc", "v_sc"):
        return ndim - 1
    return None


def head_shards(cfg, mesh) -> int:
    """How many contiguous blocks ``mesh`` cuts the kv heads into: its
    model-axis width when the layer's heads split
    (:func:`heads_shardable`), else 1 (the heads stay whole on every
    rank)."""
    if heads_shardable(mesh, cfg.n_heads, cfg.n_kv_heads):
        return model_width(mesh)
    return 1


def serving_cache_pspecs(cfg, cache_tree: PyTree, mesh) -> PyTree:
    """Serving-KV placements: **kv heads over the model axis** when the
    layer's heads split (:func:`heads_shardable`, the rule its weights
    follow), for the dense ring ``(n, B, C, Hkv, Dh)`` and the paged
    pool ``(n, P+1, page, Hkv, Dh)`` alike (head dim ``ndim - 2``), int8
    ring scales ``(n, B, C, H)`` (head dim last); ``pos`` and recurrent
    state replicated.  Each shard scatters and attends its own heads.
    The model allocates a cache at these local widths inside the
    slice's mesh context."""
    split = heads_shardable(mesh, cfg.n_heads, cfg.n_kv_heads)

    def visit(path, leaf):
        d = kv_head_dim(path[-1], leaf.dim())
        return Shard(d) if split and d is not None else Replicate()

    return _map(visit, cache_tree)


# ---------------------------------------------------------------------------
# Cutting full trees into this rank's shards
# ---------------------------------------------------------------------------


def local_shard(x: torch.Tensor, placement, mesh, offset: int = 0):
    """This rank's shard of the full tensor ``x`` under ``placement`` on
    the model axis (``offset`` shifts the dim, for one block of a
    stacked leaf).  A shard is a copy, so the full tensor can go; a
    replicated leaf is ``x`` itself."""
    if not isinstance(placement, Shard):
        return x
    d = placement.dim + offset
    w = x.shape[d] // model_width(mesh)
    i = mesh.get_local_rank(MODEL_AXIS)
    return x.narrow(d, i * w, w).clone(memory_format=torch.contiguous_format)


def shard_params(params: PyTree, cfg, mesh) -> PyTree:
    """This rank's shards of ``params``.  A leaf at its full size on its
    split dim is cut; a leaf already at its local size (weights
    initialized on the slice) is kept, so placing twice is placing
    once."""
    n = model_width(mesh)

    def visit(path, leaf):
        spec = leaf_placement(cfg, path, mesh)
        if not isinstance(spec, Shard):
            return leaf
        name = path[-2] if path[-1] == "q8" else path[-1]
        size, got = _global_size(cfg, name), leaf.shape[spec.dim]
        if got == size:
            return local_shard(leaf, spec, mesh)
        if got != size // n:
            raise ValueError(
                f"param {'/'.join(path)}: dim {spec.dim} has {got}, "
                f"neither the full {size} nor the local {size // n}"
            )
        return leaf

    return _map(visit, params)


def place_serving_state(cfg, params: PyTree, cache_trees: Sequence[PyTree],
                        mesh):
    """Lay a serving instance's state out on its slice: this rank's
    shards of ``params`` (by the rule table), and the placements of its
    caches (:func:`serving_cache_pspecs`), which say how a P→D handoff
    of the same structure is laid out.  The caches must have been
    allocated at their local widths, inside the slice's mesh context;
    one at full width raises.  Returns ``(params, [cache placement
    trees...])``."""
    n = model_width(mesh)
    specs = []
    for tree in cache_trees:
        ps = serving_cache_pspecs(cfg, tree, mesh)

        def check(path, leaf, spec):
            if isinstance(spec, Shard) and leaf.shape[spec.dim] * n != \
                    cfg.n_kv_heads:
                raise ValueError(
                    f"cache {'/'.join(path)}: {leaf.shape[spec.dim]} kv "
                    f"heads, not this rank's {cfg.n_kv_heads // n}; "
                    "allocate caches inside mesh_context(mesh)"
                )

        _map(check, tree, ps)
        specs.append(ps)
    return shard_params(params, cfg, mesh), specs
