"""Sharding rules of a serving slice: which dim of each leaf goes on the
``"model"`` axis, and the cut of a full tree into this rank's shards.

Counterpart of the serving subset of ``repro/distributed/sharding.py``
(the rule table, ``param_pspecs``, ``serving_cache_pspecs``,
``place_serving_state``).  A rule gives a leaf one placement on the
slice's ``"model"`` mesh dim, ``Shard(d)``, :class:`Segments` or
``Replicate()``: Megatron tensor parallelism, with wq, wk, wv, w_gate
and w_in column-parallel (their output dim split), wo and w_out
row-parallel (their input dim split; the model sums their outputs over
``"model"``), embed and lm_head split over the vocabulary; a MoE's
expert weights ``(E, d, ffe)`` / ``(E, ffe, d)`` split on E (the JAX
rule's ``is_moe`` branch) with the router whole; a Mamba2 mixer's SSD
heads split (``ssd_head_pspec``).  A dim whose global size does not
divide the axis stays replicated (the JAX rule's ``_fits``): a layer
whose SSD heads or experts do not divide keeps them whole on every rank.

Two rules differ from the JAX package's in layout, not in mathematics.
GSPMD splits wq's columns whenever ``q_dim`` divides the axis and
inserts whatever collectives follow; the port computes attention on
local heads, so a layer's attention weights shard only when its heads do
(:func:`~repro_torch.distributed.context.heads_shardable`, the rule of
the decode-attention wrappers) and otherwise stay replicated, with its
KV cache: the wrappers' own fallback.  And GSPMD cuts ``in_proj``'s
concatenated output ``[z | x | B | C | dt]`` uniformly and reshards;
the port runs each rank's SSD heads on local shards, so ``in_proj`` and
``conv_w`` are cut by segment (:class:`Segments`): a rank holds its
heads' z, x and dt columns (its x conv channels) and the B and C
columns whole (the configs have one B/C group).  ``dt_bias``, ``A_log``,
``D`` and ``gnorm`` follow the heads, ``out_proj`` is row-parallel like
``wo``, and the cache's SSM state and conv tail split the same way
(:func:`cache_cut`).

A slice's ``"data"`` axis has width 1, so the JAX rule's second,
FSDP-style dim over the data-parallel axes never fits and is left out,
as are the dry-run's ``fsdp_sp`` mode, ``batch_pspec`` and
``cache_pspecs``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence, Tuple

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
# model axis; None replicates.  The JAX rule table's dense entries: MoE
# expert leaves (under "moe") and the Mamba2 leaves (under "mamba") take
# their own placements (:func:`leaf_placement`).
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
    "norm": None,
    "q_norm": None,
    "k_norm": None,
    "final_norm": None,
}
_ATTN_WEIGHTS = frozenset({"wq", "wk", "wv", "wo"})
_EXPERT_WEIGHTS = frozenset({"w_gate", "w_in", "w_out"})
# Mamba2 leaves that follow the SSD heads on their first (unstacked) dim
_SSD_HEAD_LEAVES = frozenset({"A_log", "dt_bias", "D", "gnorm", "out_proj"})


@dataclass(frozen=True)
class Segments:
    """The placement of a leaf that is a concatenation along ``dim``,
    for parameters and serving-cache leaves alike.  Each of ``parts`` is
    ``(global size, heads)``: a part with heads is cut into contiguous
    blocks of whole heads over the model axis (``size // heads``
    elements a head), a part without (0) is held whole by every rank,
    and a shard keeps the parts in order.  ``kind`` names the heads:
    ``"kv"`` (attention kv heads) or ``"ssm"`` (SSD heads).  A K/V leaf
    is one part of kv heads; a Mamba2 ``in_proj`` is ``[z | x | B | C |
    dt]`` with B and C whole, its ``conv_w`` and conv tail ``[x | B |
    C]``."""
    dim: int
    parts: Tuple[Tuple[int, int], ...]
    kind: str

    @property
    def heads(self) -> int:
        """The head count of the parts that are cut (one for all)."""
        return max(heads for _, heads in self.parts)

    def widths(self, n: int = 1) -> Tuple[int, ...]:
        """Each part's size on one of ``n`` shards (1: the global
        sizes)."""
        return tuple(size // n if heads else size
                     for size, heads in self.parts)

    def starts(self, n: int = 1) -> Tuple[int, ...]:
        """Where each part begins along ``dim`` on one of ``n`` shards."""
        at, out = 0, []
        for w in self.widths(n):
            out.append(at)
            at += w
        return tuple(out)

    def size(self, n: int = 1) -> int:
        """The dim's size on one of ``n`` shards (1: the global size)."""
        return sum(self.widths(n))


def _splits(n: int, count: int) -> bool:
    """Whether ``count`` units split over a model axis ``n`` wide."""
    return n > 1 and count % n == 0


def _ssd_dims(cfg):
    """(d_inner, SSD heads, state dim) of a config's Mamba2 mixer."""
    m = cfg.mamba
    return m.d_inner(cfg.d_model), m.n_heads(cfg.d_model), m.d_state


def _conv_segments(cfg, dim: int) -> Segments:
    """A Mamba2 conv's channels ``[x | B | C]`` along ``dim``: the x
    channels by SSD head, B and C whole."""
    di, nh, N = _ssd_dims(cfg)
    return Segments(dim, ((di, nh), (2 * N, 0)), "ssm")


def _mamba_placement(cfg, name: str, n: int, off: int):
    """A Mamba2 leaf's placement: its SSD heads over the model axis when
    they divide it (``ssd_head_pspec``), every leaf whole otherwise."""
    di, nh, N = _ssd_dims(cfg)
    if not _splits(n, nh):
        return Replicate()
    if name == "in_proj":  # (d, z | x | B | C | dt)
        return Segments(1 + off, ((di, nh), (di, nh), (2 * N, 0), (nh, nh)),
                        "ssm")
    if name == "conv_w":  # (x | B | C, K)
        return _conv_segments(cfg, off)
    if name in _SSD_HEAD_LEAVES:
        return Shard(off)
    return Replicate()


def _global_size(cfg, path):
    """The global size of a leaf's ``Shard`` dim, which ``_fits`` is
    decided on, so that a full tree and this rank's shards get the same
    placements."""
    name = path[-1]
    if "moe" in path and name in _EXPERT_WEIGHTS:
        return cfg.moe.num_experts
    if "mamba" in path:
        di, nh, _ = _ssd_dims(cfg)
        return di if name in ("gnorm", "out_proj") else nh
    return {
        "embed": cfg.vocab_size, "lm_head": cfg.vocab_size,
        "wq": cfg.q_dim, "wo": cfg.q_dim, "wk": cfg.kv_dim,
        "wv": cfg.kv_dim, "w_gate": cfg.d_ff, "w_in": cfg.d_ff,
        "w_out": cfg.d_ff,
    }.get(name)


def _param_path(path):
    """``path`` read as the rules read it: a quantized weight's ``q8``
    takes its parent leaf's rule."""
    path = tuple(path)
    return path[:-1] if path[-1] == "q8" else path


def leaf_placement(cfg, path, mesh):
    """The placement on the model axis of the parameter at ``path``
    (its keys in the param tree): ``Shard(d)`` of the leaf (counting the
    leading ``n_blocks`` axis of a stacked block leaf), a Mamba2
    projection's :class:`Segments`, or ``Replicate()``.  It depends on
    the config and the path, not on the leaf's shape, so a draw is cut
    before the next one is made."""
    if tuple(path)[-1] == "sc":  # int8 weight scales: tiny, replicated
        return Replicate()
    path = _param_path(path)
    name = path[-1]
    n = model_width(mesh)
    off = 1 if "blocks" in path else 0
    if n < 2:
        return Replicate()
    if "mamba" in path:
        return _mamba_placement(cfg, name, n, off)
    if "moe" in path and name in _EXPERT_WEIGHTS:  # (E, d, ffe) on E
        return Shard(off) if _splits(n, cfg.moe.num_experts) \
            else Replicate()
    rule = _PARAM_RULES.get(name)
    size = _global_size(cfg, path)
    if rule is None or size is None or size % n:
        return Replicate()
    if "attn" in path and name in _ATTN_WEIGHTS and not heads_shardable(
            mesh, cfg.n_heads, cfg.n_kv_heads):
        return Replicate()
    return Shard(rule + off)


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


def cache_cut(cfg, name: str, ndim: int):
    """The :class:`Segments` of a serving cache leaf named ``name``: K/V
    (the dense ring ``(n, B, C, Hkv, Dh)``, the paged pool ``(n, P+1,
    page, Hkv, Dh)``) on dim ``ndim - 2``, int8 ring scales ``(n, B, C,
    H)`` on the last, a Mamba2 SSM state ``(n, B, H, P, N)`` on its head
    dim and its conv tail ``(n, B, K-1, x | B | C)`` on its channels;
    None for a leaf without heads (``pos``)."""
    if name in ("k", "v", "k_sc", "v_sc"):
        dim = ndim - 2 if name in ("k", "v") else ndim - 1
        return Segments(dim, ((cfg.n_kv_heads, cfg.n_kv_heads),), "kv")
    if name == "ssm":
        nh = _ssd_dims(cfg)[1]
        return Segments(ndim - 3, ((nh, nh),), "ssm")
    if name == "conv":
        return _conv_segments(cfg, ndim - 1)
    return None


def head_shards(cfg, mesh, kind: str = "kv") -> int:
    """How many contiguous blocks ``mesh`` cuts a layer's heads of
    ``kind`` into: its model-axis width when they split (attention:
    :func:`heads_shardable`; SSD heads: the width divides them), else 1
    (the heads stay whole on every rank)."""
    n = model_width(mesh)
    if kind == "ssm":
        return n if cfg.mamba and _splits(n, _ssd_dims(cfg)[1]) else 1
    return n if heads_shardable(mesh, cfg.n_heads, cfg.n_kv_heads) else 1


def serving_cache_pspecs(cfg, cache_tree: PyTree, mesh) -> PyTree:
    """Serving-cache placements (:func:`cache_cut`): **kv heads over the
    model axis** when the layer's heads split (:func:`heads_shardable`,
    the rule its weights follow), for the dense ring, the paged pool and
    int8 ring scales; **SSD heads** when they split, for the SSM state
    and the conv tail (its x channels cut, B and C whole); ``pos``
    replicated.  Each shard scatters and attends (or scans) its own
    heads.  The model allocates a cache at these local widths inside
    the slice's mesh context."""
    def visit(path, leaf):
        cut = cache_cut(cfg, path[-1], leaf.dim())
        if cut is None or head_shards(cfg, mesh, cut.kind) == 1:
            return Replicate()
        return cut

    return _map(visit, cache_tree)


# ---------------------------------------------------------------------------
# Cutting full trees into this rank's shards
# ---------------------------------------------------------------------------


def _cut(x: torch.Tensor, placement, i: int, n: int, offset: int = 0):
    """Shard ``i`` of ``n`` of ``x`` under ``placement`` (a view, or a
    concatenation for :class:`Segments`)."""
    d = placement.dim + offset
    if isinstance(placement, Shard):
        w = x.shape[d] // n
        return x.narrow(d, i * w, w)
    pieces = [x.narrow(d, at + (i * w if heads else 0), w)
              for (_, heads), at, w in zip(placement.parts,
                                           placement.starts(),
                                           placement.widths(n))]
    return torch.cat(pieces, d)


def local_shard(x: torch.Tensor, placement, mesh, offset: int = 0):
    """This rank's shard of the full tensor ``x`` under ``placement`` on
    the model axis (``offset`` shifts the dim, for one block of a
    stacked leaf).  A shard is a copy, so the full tensor can go; a
    replicated leaf is ``x`` itself."""
    if not isinstance(placement, (Shard, Segments)):
        return x
    part = _cut(x, placement, mesh.get_local_rank(MODEL_AXIS),
                model_width(mesh), offset)
    return part.clone(memory_format=torch.contiguous_format)


def _sizes(cfg, path, spec, n: int):
    """(global, local) size of the split dim of the leaf at ``path``."""
    if isinstance(spec, Segments):
        return spec.size(), spec.size(n)
    size = _global_size(cfg, path)
    return size, size // n


def shard_params(params: PyTree, cfg, mesh) -> PyTree:
    """This rank's shards of ``params``.  A leaf at its full size on its
    split dim is cut; a leaf already at its local size (weights
    initialized on the slice) is kept, so placing twice is placing
    once."""
    n = model_width(mesh)

    def visit(path, leaf):
        spec = leaf_placement(cfg, path, mesh)
        if not isinstance(spec, (Shard, Segments)):
            return leaf
        size, local = _sizes(cfg, _param_path(path), spec, n)
        got = leaf.shape[spec.dim]
        if got == size:
            return local_shard(leaf, spec, mesh)
        if got != local:
            raise ValueError(
                f"param {'/'.join(path)}: dim {spec.dim} has {got}, "
                f"neither the full {size} nor the local {local}"
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
    one at full width raises (kv heads, SSD heads and conv channels
    alike).  Returns ``(params, [cache placement trees...])``."""
    specs = []
    for tree in cache_trees:
        ps = serving_cache_pspecs(cfg, tree, mesh)

        def check(path, leaf, spec):
            if isinstance(spec, Replicate):
                return
            want = spec.size(model_width(mesh))
            if leaf.shape[spec.dim] != want:
                raise ValueError(
                    f"cache {'/'.join(path)}: dim {spec.dim} has "
                    f"{leaf.shape[spec.dim]}, not this rank's {want} "
                    f"({spec.kind} heads); allocate caches inside "
                    "mesh_context(mesh)"
                )

        _map(check, tree, ps)
        specs.append(ps)
    return shard_params(params, cfg, mesh), specs
