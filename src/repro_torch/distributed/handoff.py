"""The P→D KV handoff between two mesh slices, whichever ranks they hold.

The JAX backend re-lays a handed-off cache onto the decode slice with
``jax.device_put`` (``repro/serving/realengine.py:503-511`` paged,
``:525-528`` dense); the single controller moves whatever bytes that
takes.  The port runs one process per rank, so this module says which
rank moves which bytes, and moves them:

* :func:`head_plan` maps each destination rank's heads to pieces of the
  source ranks' shards.  Both slices cut heads by the sharding rules
  (contiguous blocks along ``"model"``, or whole on every rank when the
  heads do not split), so the plan is a function of the head count, the
  two slices' ranks and how many shards each cuts the heads into.  A
  leaf's heads are attention kv heads (K/V, int8 scales) or SSD heads (a
  Mamba2 SSM state, and the x channels of its conv tail), each kind
  with its own shard count on each slice
  (:func:`~repro_torch.distributed.sharding.cache_cut`).
* :class:`Header` is what every rank of the world knows of a payload:
  the source slice, how many shards it cuts each kind of heads into,
  and each leaf's shape, dtype and cut on one source rank.  A rank
  outside the source slice builds it from the config and the request,
  never from tensors it does not hold.
* :func:`move` runs this rank's part of a handoff, leaf by leaf and
  piece by piece in one fixed order that every rank walks: a rank on
  both ends of a piece copies locally, the source sends, the destination
  receives into freshly allocated leaves, and any other rank does
  nothing.  Only heads are cut: every other axis moves whole, a conv
  tail's B and C channels move whole beside its cut x channels, and a
  leaf without heads (ring positions) moves whole from one source rank.
* :func:`share` broadcasts token ids from a slice's first rank to the
  whole world, so that ranks outside the slice emit the same streams.

Transport: gloo, which the port picks when ranks share a card, moves
host memory only (a device pointer fails in its socket write), so a
device leaf is staged through a pinned host buffer on each end.  Under
NCCL (a card per rank) device tensors go as they are; that branch has
not run on a card yet.  Each call waits at most the process group's
timeout (:func:`~repro_torch.distributed.context.init_world`), so a
missing peer fails instead of hanging.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Segments, cache_cut


@dataclass(frozen=True)
class Piece:
    """Global heads ``[lo, hi)`` that rank ``dst`` takes from rank
    ``src``; ``src_off`` and ``dst_off`` are the first head's index in
    the source's and the destination's shard."""
    src: int
    dst: int
    lo: int
    hi: int
    src_off: int
    dst_off: int


def _holders(ranks: Sequence[int], shards: int, s: int) -> List[int]:
    """The ranks of a slice that hold head shard ``s`` (coordinate ``i``
    holds shard ``i * shards // len(ranks)``)."""
    n = len(ranks)
    return [r for i, r in enumerate(ranks) if i * shards // n == s]


def head_plan(hkv: int, src_ranks: Sequence[int], dst_ranks: Sequence[int],
              src_shards: Optional[int] = None,
              dst_shards: Optional[int] = None) -> Dict[int, List[Piece]]:
    """{destination rank: the pieces that fill its heads, in head
    order}.  A slice cuts its ``hkv`` heads into ``*_shards`` contiguous
    blocks over its ranks in order (default: one a rank; 1 when the
    heads stay whole on every rank).  A piece comes from the destination
    rank itself when it holds those heads, else from the first source
    rank that does."""
    src_ranks, dst_ranks = list(src_ranks), list(dst_ranks)
    src_shards = len(src_ranks) if src_shards is None else src_shards
    dst_shards = len(dst_ranks) if dst_shards is None else dst_shards
    for name, ranks, shards in (("source", src_ranks, src_shards),
                                ("destination", dst_ranks, dst_shards)):
        if shards < 1 or hkv % shards or len(ranks) % shards:
            raise ValueError(
                f"{name} slice of {len(ranks)} ranks cannot cut {hkv} "
                f"heads into {shards} shards"
            )
    ws, wd = hkv // src_shards, hkv // dst_shards
    plan = {}
    for j, d in enumerate(dst_ranks):
        lo_d = (j * dst_shards // len(dst_ranks)) * wd
        pieces = []
        for s in range(lo_d // ws, (lo_d + wd - 1) // ws + 1):
            holders = _holders(src_ranks, src_shards, s)
            src = d if d in holders else holders[0]
            lo, hi = max(lo_d, s * ws), min(lo_d + wd, (s + 1) * ws)
            pieces.append(Piece(src, d, lo, hi, lo - s * ws, lo - lo_d))
        plan[d] = pieces
    return plan


@dataclass(frozen=True)
class Leaf:
    """One leaf of a payload tree: its path, its shape and dtype on one
    source rank, and how it splits over heads (None: the leaf has no
    heads)."""
    name: str
    key: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    cut: Optional[Segments]


@dataclass(frozen=True)
class Header:
    """What every rank knows of a payload: the source slice's ranks, how
    many shards it cuts each kind of heads into (``(kind, shards)``
    pairs), and its leaves."""
    src_ranks: Tuple[int, ...]
    src_shards: Tuple[Tuple[str, int], ...]
    leaves: Tuple[Leaf, ...]


def leaves_of(cfg, tree, n_pages: Optional[int] = None) -> Tuple[Leaf, ...]:
    """The leaves of a cache tree of ``cfg`` (real or on the meta
    device) in tree order; ``n_pages`` replaces dim 1 (a paged pool's
    page count) by a request's page stack."""
    out = []
    for name, entry in tree.items():
        for key, leaf in entry.items():
            shape = tuple(leaf.shape)
            if n_pages is not None:
                shape = (shape[0], n_pages) + shape[2:]
            out.append(Leaf(name, key, shape, leaf.dtype,
                            cache_cut(cfg, key, leaf.dim())))
    return tuple(out)


@dataclass
class Payload:
    """A request's migrating cache: this rank's shards (``tree``; None on
    a rank outside the source slice), the paged token count ``L`` (None
    for a dense cache), and the header (None on the meshless path)."""
    tree: Optional[dict]
    L: Optional[int] = None
    header: Optional[Header] = None


def _host_staged(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() != "nccl"


def _send(t: torch.Tensor, dst: int) -> int:
    t = t.contiguous()
    if _host_staged(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    dist.send(t, dst)
    return t.numel() * t.element_size()


def _recv_into(view: torch.Tensor, src: int) -> int:
    if _host_staged(view):
        buf = torch.empty(view.shape, dtype=view.dtype, pin_memory=True)
    else:
        buf = torch.empty(view.shape, dtype=view.dtype, device=view.device)
    dist.recv(buf, src)
    view.copy_(buf)
    return buf.numel() * buf.element_size()


def _narrow(dim: int, at: int, n: int):
    return lambda t: t.narrow(dim, at, n)


def _transfers(leaf: Leaf, plan, src_ranks, src_shards, dst_shards):
    """(source rank, destination rank, source view, destination view)
    makers of one leaf in plan order (``plan``: the :func:`head_plan` of
    its heads).  A leaf with heads goes part by part at each slice's
    offsets (:class:`~repro_torch.distributed.sharding.Segments`): a
    part of heads piece by piece, a part every rank holds whole (a conv
    tail's B and C) from the destination itself when it is a source
    rank, else from its first piece's source.  A leaf without heads goes
    whole, from the destination itself when it is a source rank, else
    from a source rank in turn."""
    cut = leaf.cut
    for j, (d, pieces) in enumerate(plan.items()):
        if cut is None:
            src = d if d in src_ranks else src_ranks[j % len(src_ranks)]
            yield src, d, (lambda t: t), (lambda t: t)
            continue
        for (size, heads), at_s, at_d in zip(
                cut.parts, cut.starts(src_shards), cut.starts(dst_shards)):
            if not heads:
                src = d if d in src_ranks else pieces[0].src
                yield (src, d, _narrow(cut.dim, at_s, size),
                       _narrow(cut.dim, at_d, size))
                continue
            u = size // heads
            for p in pieces:
                n = (p.hi - p.lo) * u
                yield (p.src, d, _narrow(cut.dim, at_s + p.src_off * u, n),
                       _narrow(cut.dim, at_d + p.dst_off * u, n))


@dataclass
class Moved:
    """What one handoff did: the destination tree on this rank (None
    off the destination slice), whether any piece crossed ranks (the
    same on every rank), and the bytes this rank sent and received."""
    tree: Optional[dict]
    crossed: bool
    bytes_sent: int = 0
    bytes_received: int = 0


def move(header: Header, tree: Optional[dict], dst_ranks: Sequence[int],
         dst_shards: Dict[str, int], device) -> Moved:
    """This rank's part of handing ``tree`` (the source shards it holds,
    or None) to the slice ``dst_ranks``, whose ranks cut each kind of
    heads into ``dst_shards[kind]``.  Every rank of the world calls it
    with the same header and destination, in the same order as every
    other handoff.  When this rank's pieces all come from itself and
    cover its shards whole, the destination tree is the source tree,
    uncopied."""
    rank = dist.get_rank()
    dst_ranks = list(dst_ranks)
    src_ranks = list(header.src_ranks)
    src_shards = dict(header.src_shards)
    plans = {}

    def leaf_plan(leaf):
        kind, units = (None, 1) if leaf.cut is None else \
            (leaf.cut.kind, leaf.cut.heads)
        if (kind, units) not in plans:
            s, d = (1, 1) if kind is None else (src_shards[kind],
                                                dst_shards[kind])
            plans[kind, units] = head_plan(units, src_ranks, dst_ranks, s, d)
        return plans[kind, units]

    def transfers(leaf):
        kind = None if leaf.cut is None else leaf.cut.kind
        return _transfers(leaf, leaf_plan(leaf), src_ranks,
                          src_shards.get(kind, 1), dst_shards.get(kind, 1))

    walk = [(leaf, list(transfers(leaf))) for leaf in header.leaves]
    crossed = any(src != d for _, ts in walk for src, d, _, _ in ts)
    mine = [src for _, ts in walk for src, d, _, _ in ts if d == rank]
    same = all(src_shards[k] == dst_shards[k] for k in src_shards)
    if mine and tree is not None and same and all(s == rank for s in mine):
        return Moved(tree, crossed)
    out = None
    if mine:
        out = {}
        for leaf in header.leaves:
            shape = list(leaf.shape)
            if leaf.cut is not None:
                shape[leaf.cut.dim] = leaf.cut.size(dst_shards[leaf.cut.kind])
            out.setdefault(leaf.name, {})[leaf.key] = torch.empty(
                shape, dtype=leaf.dtype, device=device)
    moved = Moved(out, crossed)
    for leaf, ts in walk:
        src_leaf = None if tree is None else tree[leaf.name][leaf.key]
        for src, d, take, put in ts:
            if src == d == rank:
                put(out[leaf.name][leaf.key]).copy_(take(src_leaf))
            elif src == rank:
                moved.bytes_sent += _send(take(src_leaf), d)
            elif d == rank:
                moved.bytes_received += _recv_into(
                    put(out[leaf.name][leaf.key]), src)
    return moved


def share(t: Optional[torch.Tensor], shape: Tuple[int, ...], src: int,
          device) -> np.ndarray:
    """Integer ids held on rank ``src`` (``t``; ignored elsewhere), as
    every rank of the world reads them: a broadcast over the world from
    ``src``, through host memory unless the backend is NCCL."""
    on = torch.device(device) if dist.get_backend() == "nccl" else \
        torch.device("cpu")
    if dist.get_rank() == src:
        buf = t.reshape(shape).to(device=on, dtype=torch.int64).contiguous()
    else:
        buf = torch.empty(shape, dtype=torch.int64, device=on)
    dist.broadcast(buf, src)
    return buf.cpu().numpy()
