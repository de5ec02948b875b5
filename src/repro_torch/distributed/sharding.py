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
FSDP-style dim over the data-parallel axes never fits there: the serving
path has one layout and ignores :class:`ShardingPolicy`'s fields.

**The reference layout** (the second half of this module) is the JAX
package's rule engine for the production meshes, ported line for line
for the dry-run (:mod:`repro_torch.launch.dryrun`), under the JAX names
where they do not clash: :func:`_leaf_spec` (with the FSDP second dim
and the ``fsdp_sp`` mode), :func:`ref_param_pspecs` (the JAX
``param_pspecs``), :func:`batch_pspec` and :func:`cache_pspecs`.  They
describe how GSPMD would lay a cell out over ``(16, 16)`` ``("data",
"model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")``, and return
plain tuples, one entry per dim: ``None``, an axis name, or a tuple of
axes.  They take any mesh that names its axes and sizes (a
``DeviceMesh``, or an object with ``axis_names`` and ``devices``, as the
JAX tests' ``FakeMesh``).  The port computes on none of these layouts:
the dry-run records its own rank program beside them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

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
    """Tunable knobs of the reference layout's rule engine (the JAX
    policy's fields).  A serving slice has one layout (Megatron tensor
    parallelism over :data:`MODEL_AXIS`) and ignores them.

    ``mode``: ``"tp"``, Megatron tensor parallelism on the model axis;
    ``"fsdp_sp"``, sequence parallelism on the model axis with weights
    flat over (dp × model), gathered per layer (MoE experts stay on
    "model").  Leaves whose bytes per model shard exceed
    ``fsdp_threshold`` also shard a second dim over ``dp_axes``;
    ``cache_seq_over_model`` shards the decode cache length over
    "model"."""

    dp_axes: Tuple[str, ...] = ("data",)  # ("pod", "data") multi-pod
    model_axis: str = MODEL_AXIS
    mode: str = "tp"
    fsdp_threshold: int = 64 * 1024 * 1024
    cache_seq_over_model: bool = True


def mesh_shape_of(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, of an object with the
    JAX mesh's ``axis_names`` and ``devices``, or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def default_policy(mesh) -> ShardingPolicy:
    """The reference's default policy of ``mesh``: its "pod" and "data"
    axes data-parallel ("data" alone for a serving slice)."""
    dp = tuple(a for a in mesh_shape_of(mesh) if a in ("pod", "data"))
    return ShardingPolicy(dp_axes=dp or ("data",))


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
    and ``sc`` take their parent leaf's rule."""
    path = tuple(path)
    return path[:-1] if path[-1] in ("q8", "sc") else path


def _matrix_ndim(path) -> int:
    """The dims of the weight at ``path`` (its parent's for a ``q8`` or
    ``sc``): a matrix, or a MoE's ``(E, d, ffe)`` / ``(E, ffe, d)``
    expert stack, behind the ``n_blocks`` axis of a stacked leaf."""
    path = _param_path(path)
    experts = "moe" in path and path[-1] in _EXPERT_WEIGHTS
    return (3 if experts else 2) + (1 if "blocks" in path else 0)


def scale_placement(parent, ndim: int):
    """The placement of an int8 weight's scales ``sc``, given its codes'
    (``parent``, of an ``ndim``-dim ``q8``): the scales are the codes with
    their input dim (-2) reduced away (:func:`~repro_torch.models.model.
    quantize_params`), so they are placed as the codes are with that dim
    removed.  A cut of the output dim (column-parallel ``wq``, ``w_gate``;
    a Mamba2 ``in_proj``'s :class:`Segments`) becomes the same cut of the
    scales' last dim, a cut of a leading dim (a MoE's experts) stays on
    it, and a cut of the input dim (row-parallel ``wo``, ``w_out``,
    ``out_proj``; a Mamba2 ``conv_w``'s channels) leaves every rank the
    whole scale row: ``quantize_params`` takes its max over
    ``"model"``."""
    if not isinstance(parent, (Shard, Segments)) or parent.dim == ndim - 2:
        return Replicate()
    if parent.dim < ndim - 2:
        return parent
    if isinstance(parent, Shard):
        return Shard(ndim - 2)
    return Segments(ndim - 2, parent.parts, parent.kind)


def leaf_placement(cfg, path, mesh):
    """The placement on the model axis of the parameter at ``path``
    (its keys in the param tree): ``Shard(d)`` of the leaf (counting the
    leading ``n_blocks`` axis of a stacked block leaf), a Mamba2
    projection's :class:`Segments`, or ``Replicate()``; an int8 weight's
    codes ``q8`` take their parent's and its scales ``sc``
    :func:`scale_placement`.  It depends on the config and the path, not
    on the leaf's shape, so a draw is cut before the next one is
    made."""
    if tuple(path)[-1] == "sc":
        return scale_placement(
            leaf_placement(cfg, _param_path(path), mesh), _matrix_ndim(path))
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


# ---------------------------------------------------------------------------
# The reference layout (the dry-run's; ``repro/distributed/sharding.py``)
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]  # per dim: None, an axis name, or a tuple of axes


def _spec(*entries) -> Spec:
    """A spec as ``PartitionSpec`` stores it: a one-axis tuple entry is
    that axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axsize(mesh_shape: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh_shape.get(axes, 1)
    n = 1
    for a in axes:
        n *= mesh_shape.get(a, 1)
    return n


def _fits(dim: int, mesh_shape: dict, axes) -> bool:
    n = _axsize(mesh_shape, axes)
    return n > 1 and dim % n == 0


# (model_dim, fsdp_dim): preferred dims (offset by +1 for stacked block
# leaves) to place on the model axis / the DP axes when FSDP kicks in
_REF_PARAM_RULES = {
    # embed: vocab over model only (2D-sharding the table turns every
    # token gather into a full rematerialization)
    "embed": (0, None),
    "lm_head": (1, 0),
    "wq": (1, 0),
    "wk": (1, 0),
    "wv": (1, 0),
    "wo": (0, 1),
    "w_gate": (1, 0),  # also a MoE's (E, d, ffe): special-cased below
    "w_in": (1, 0),
    "w_out": (0, 1),
    "router": (None, None),
    "in_proj": (1, 0),
    "conv_w": (0, None),
    "out_proj": (0, 1),
    "gnorm": (None, None),
    "norm": (None, None),
    "q_norm": (None, None),
    "k_norm": (None, None),
    "final_norm": (None, None),
    "A_log": (None, None),
    "dt_bias": (None, None),
    "D": (None, None),
}


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], dtype,
               mesh_shape: dict, pol: ShardingPolicy) -> Spec:
    """The reference spec of one parameter leaf (``dtype`` a torch
    dtype)."""
    name = path[-1]
    if name == "sc":  # int8 weight scales: tiny, replicated
        return _spec(*[None] * len(shape))
    if name == "q8":  # quantized weight: rules of the parent leaf
        name = path[-2]
        path = path[:-1]
    stacked = "blocks" in path  # leading n_blocks axis of the stack
    off = 1 if stacked else 0
    ndim = len(shape)
    spec: list = [None] * ndim

    is_moe = name in ("w_gate", "w_in", "w_out") and ndim - off == 3
    if is_moe:
        # (E, d, ffe) / (E, ffe, d): experts on model; inner dim on dp if big
        mdim, fdim = off + 0, off + 2
    else:
        rule = _REF_PARAM_RULES.get(name)
        if rule is None or rule[0] is None:
            mdim = fdim = None
        else:
            mdim = off + rule[0] if rule[0] is not None else None
            fdim = off + rule[1] if rule[1] is not None else None

    if pol.mode == "fsdp_sp" and not (is_moe and name != "router"):
        # flat weight sharding: the preferred dim takes (dp × model),
        # falling back to smaller axis sets
        if mdim is not None and mdim < ndim:
            for axes in ((*pol.dp_axes, pol.model_axis), (pol.model_axis,),
                         pol.dp_axes):
                if _fits(shape[mdim], mesh_shape, axes):
                    spec[mdim] = axes if len(axes) > 1 else axes[0]
                    break
        return _spec(*spec)

    model_sharded = False
    if mdim is not None and mdim < ndim and _fits(
            shape[mdim], mesh_shape, pol.model_axis):
        spec[mdim] = pol.model_axis
        model_sharded = True
    # capacity-aware second-dim sharding; a stacked leaf is scanned one
    # block at a time, so its live working set is one slice
    n_elems = float(math.prod(shape)) / (shape[0] if stacked else 1)
    per_model_shard = n_elems * dtype.itemsize / (
        _axsize(mesh_shape, pol.model_axis) if model_sharded else 1)
    if (fdim is not None and fdim < ndim and fdim != mdim
            and spec[fdim] is None
            and per_model_shard > pol.fsdp_threshold
            and _fits(shape[fdim], mesh_shape, pol.dp_axes)):
        spec[fdim] = pol.dp_axes
    return _spec(*spec)


def ref_param_pspecs(cfg, param_tree: PyTree, mesh,
                     pol: Optional[ShardingPolicy] = None) -> PyTree:
    """The JAX ``param_pspecs``: the reference spec tree mirroring
    ``param_tree`` (any tree of tensors with ``shape`` and ``dtype``, on
    the meta device for a full-size config)."""
    pol = pol or default_policy(mesh)
    mesh_shape = mesh_shape_of(mesh)
    return _map(lambda path, leaf: _leaf_spec(
        path, tuple(leaf.shape), leaf.dtype, mesh_shape, pol), param_tree)


def batch_pspec(batch: int, mesh, ndim: int = 2,
                pol: Optional[ShardingPolicy] = None,
                seq_len: int = 0) -> Spec:
    """Tokens/labels (B, S, ...): B over the DP axes when divisible (else
    the longest prefix of them that divides, else replicated); in
    ``fsdp_sp`` mode the sequence dim also shards over "model"."""
    pol = pol or default_policy(mesh)
    mesh_shape = mesh_shape_of(mesh)
    rest = [None] * (ndim - 1)
    if (pol.mode == "fsdp_sp" and ndim >= 2 and seq_len
            and _fits(seq_len, mesh_shape, pol.model_axis)):
        rest[0] = pol.model_axis
    if _fits(batch, mesh_shape, pol.dp_axes):
        return _spec(pol.dp_axes, *rest)
    for k in range(len(pol.dp_axes) - 1, 0, -1):
        if _fits(batch, mesh_shape, pol.dp_axes[:k]):
            return _spec(pol.dp_axes[:k], *rest)
    return _spec(None, *rest)


def _seq_spec(B: int, C: int, mesh_shape: dict, pol: ShardingPolicy,
              trailing: int) -> Spec:
    """A cache leaf ``(n, B, C, ...)``: B over the DP axes and C over
    "model"; where B cannot shard (long_500k's batch of 1), C over every
    axis it divides."""
    rest = (None,) * trailing
    b_ax = pol.dp_axes if _fits(B, mesh_shape, pol.dp_axes) else None
    if b_ax is None:
        seq = tuple(a for a in (*pol.dp_axes, pol.model_axis)
                    if _fits(C, mesh_shape, (a,)))
        if seq and _fits(C, mesh_shape, seq):
            return _spec(None, None, seq, *rest)
        return _spec(None, None, None, *rest)
    c_ax = (pol.model_axis if pol.cache_seq_over_model
            and _fits(C, mesh_shape, pol.model_axis) else None)
    return _spec(None, b_ax, c_ax, *rest)


def cache_pspecs(cfg, cache_tree: PyTree, mesh,
                 pol: Optional[ShardingPolicy] = None) -> PyTree:
    """The reference decode-cache specs: DP on the batch; the cache
    length (sequence-parallel decode) or the SSM heads on "model"."""
    pol = pol or default_policy(mesh)
    mesh_shape = mesh_shape_of(mesh)

    def visit(path, leaf):
        name, shape = path[-1], tuple(leaf.shape)
        if name in ("k", "v"):  # (n, B, C, Hkv, Dh)
            return _seq_spec(shape[1], shape[2], mesh_shape, pol, 2)
        if name in ("k_sc", "v_sc"):  # (n, B, C, H)
            return _seq_spec(shape[1], shape[2], mesh_shape, pol, 1)
        if name == "pos":  # (n, B, C)
            return _seq_spec(shape[1], shape[2], mesh_shape, pol, 0)
        if name == "ssm":  # (n, B, H, P, N)
            _, B, H, _, _ = shape
            b_ax = pol.dp_axes if _fits(B, mesh_shape, pol.dp_axes) else None
            h_ax = (pol.model_axis if _fits(H, mesh_shape, pol.model_axis)
                    else None)
            return _spec(None, b_ax, h_ax, None, None)
        if name == "conv":  # (n, B, K-1, conv_dim)
            _, B, _, D = shape
            b_ax = pol.dp_axes if _fits(B, mesh_shape, pol.dp_axes) else None
            d_ax = (pol.model_axis if _fits(D, mesh_shape, pol.model_axis)
                    else None)
            return _spec(None, b_ax, None, d_ax)
        return _spec(*[None] * len(shape))

    return _map(visit, cache_tree)
