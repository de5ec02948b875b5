"""Wrappers of the decode-attention kernels: ring decode
(``csrc/ring_decode.cu``) and paged decode / speculative verify
(``csrc/paged_attention.cu``).

A CUDA tensor launches the Hopper kernel (or raises); a CPU tensor takes
the plain version in ``ref.py``.  ``launches`` counts ring-decode
calls that launched; ``paged_launches`` maps each query-token count T to
the paged wrapper's calls that launched with it (T == 1 is paged
decode).  In bfloat16 a call of either kernel is two launches, the split
(over ring slots, or over positions) and the combine; it counts once.

The paged kernel holds at most ``PAGED_ROWS`` = 32 query rows (T · G)
per kv head, as one or two m16 fragments in bfloat16 and one warp a row
in float32.  The reference groups any T · G.  So for wider groups (G =
12 at T = 3 is 36 rows) the wrapper splits each kv head's G query heads
into sub-groups of G' heads, G' the largest divisor of G with T · G' <=
32, runs the kernel on each sub-group (Hq' = Hkv · G', the heads gathered
contiguous) and scatters the outputs back (:func:`by_head_subgroups`).
Attention is independent per query head, so each row is what an
unsplit kernel would give it, and a split call still counts once.

**Mesh sharding** (``repro/kernels/decode_attention/ops.py:48,86,122``).
Pass ``mesh=`` (an instance's slice, axes ("data", "model")) and, when
Hq and Hkv both divide the ``axis`` width
(:func:`repro_torch.distributed.context.heads_shardable`), each wrapper
runs as ``shard_map`` runs it: q, K and V are DTensors placed ``Shard``
on their head dim over ``axis``, each rank runs the unmodified kernel on
its ``Hkv / tp`` heads (attention decomposes per KV head, so no shard
talks to another), and the output is a DTensor with q's placement.
Block tables, lengths and positions are replicated: a page id names the
same page on every shard, which keeps the host's ``KVPool`` arithmetic
shard-agnostic.  When the heads do not divide, or the axis has width 1,
the wrapper makes the unsharded call.  The model, which holds only its
local heads, calls the sharded branch on them directly
(:func:`on_local_heads`), with no DTensor.  ``sharded_launches`` counts
the kernel launches the sharded branch made on this rank, keyed by
(wrapper, local Hkv).

Under :func:`repro_torch.device.analysis_mode` a call on meta tensors
is traced: it counts and reports its cost (:func:`ring_decode_cost`,
:func:`paged_cost`) and returns an output of the launch's shape without
building the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import on_card
from repro_torch.distributed.context import heads_shardable, model_width
from repro_torch.kernels import _build, record_cost
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_verify_attention_ref,
)

PAGED_ROWS = 32  # query rows (T * G) per kv head one paged launch holds

launches = 0
paged_launches: Dict[int, int] = {}
sharded_launches: Dict[Tuple[str, int], int] = {}
_fn = None
_paged_fn = None


def ring_decode_cost(B: int, C: int, Hq: int, Hkv: int, Dh: int, esz: int,
                     valid: Optional[int] = None,
                     empty: int = 0) -> Tuple[float, float]:
    """(flops, bytes) of one ``ring_decode`` call over ``valid`` live
    (row, slot) pairs (every slot without) and ``empty`` rows with no
    live slot: 4 Dh operations a live pair and query head; the live
    slots' K and V, all of V for an empty row (its mean), the slot
    positions, q and out, each moved once."""
    valid = B * C if valid is None else valid
    nbytes = (2 * B * Hq * Dh + (2 * valid + empty * C) * Hkv * Dh) * esz \
        + B * C * 4 + B * 4
    return 4.0 * valid * Hq * Dh, float(nbytes)


def paged_cost(B: int, T: int, Hq: int, Hkv: int, Dh: int, esz: int,
               table: int, lengths: Sequence[int],
               window: Optional[int] = None) -> Tuple[float, float]:
    """(flops, bytes) of one paged call with T query tokens a row over
    rows of ``lengths`` valid tokens (the T new ones last) and a block
    table of ``table`` entries: 4 Dh operations a visible (query, key)
    pair and query head; each row's valid K and V, q, out, the table and
    the lengths, each moved once."""
    pairs = 0
    for n in lengths:
        for t in range(T):
            qpos = n - T + t
            lo = 0 if window is None else max(0, qpos - window + 1)
            pairs += max(0, min(qpos, n - 1) - lo + 1)
    nbytes = (2 * B * T * Hq * Dh + 2 * sum(lengths) * Hkv * Dh) * esz \
        + table * 4 + B * 4
    return 4.0 * pairs * Hq * Dh, float(nbytes)


def _launched() -> int:
    """Kernel launches made on this rank so far (both kernels)."""
    return launches + sum(paged_launches.values())


def on_local_heads(fn: Callable, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *replicated: torch.Tensor, mesh,
                   axis: str = "model", **kw) -> torch.Tensor:
    """The sharded branch of the wrapper ``fn`` on this rank's own heads:
    ``q``, ``k`` and ``v`` hold its Hq/tp and Hkv/tp heads of a layer
    whose heads divide ``mesh``'s ``axis``; tables, lengths and
    positions are whole.  Runs the unsharded wrapper on them (the kernel
    on the card, the plain version on the CPU) and adds the kernel
    launches it made to ``sharded_launches``."""
    if model_width(mesh, axis) < 2:
        raise ValueError(f"{fn.__name__}: the mesh's {axis!r} axis has "
                         "width 1 and splits no heads")
    before = _launched()
    out = fn(q, k, v, *replicated, **kw)
    made = _launched() - before
    if made:
        key = (fn.__name__, k.shape[-2])
        sharded_launches[key] = sharded_launches.get(key, 0) + made
    return out


def _shard_map(fn: Callable, mesh, axis: str,
               sharded: Sequence[torch.Tensor],
               replicated: Sequence[torch.Tensor], kw: dict):
    """``shard_map`` over a ``DeviceMesh``: ``sharded`` holds q, K and V
    as DTensors, each placed ``Shard`` on its head dim (``ndim - 2``)
    over ``axis`` and ``Replicate`` elsewhere; ``replicated`` are plain
    tensors or replicated DTensors.  Runs :func:`on_local_heads` on this
    rank's local views; the output is a DTensor placed as q is."""
    name = fn.__name__
    md = mesh.mesh_dim_names.index(axis)
    views = []
    for t in sharded:
        want = tuple(Shard(t.dim() - 2) if i == md else Replicate()
                     for i in range(mesh.ndim))
        if not isinstance(t, DTensor) or t.device_mesh != mesh \
                or tuple(t.placements) != want:
            raise ValueError(
                f"{name}: the heads shard over {axis!r}; pass DTensors "
                f"placed {want} on the mesh"
            )
        views.append(t.to_local())
    for t in replicated:
        if isinstance(t, DTensor):
            if not all(p.is_replicate() for p in t.placements):
                raise ValueError(f"{name}: tables, lengths and positions "
                                 "must be replicated")
            t = t.to_local()
        views.append(t)
    out = on_local_heads(fn, *views, mesh=mesh, axis=axis, **kw)
    return DTensor.from_local(out, mesh, sharded[0].placements,
                              run_check=False)


def _unsharded(name: str, q) -> None:
    if isinstance(q, DTensor):
        raise ValueError(f"{name}: the heads do not shard over the mesh; "
                         "pass plain tensors")


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ring_decode")
        fn = lib.repro_ring_decode
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        scratch = lib.repro_ring_decode_scratch_floats
        scratch.argtypes = [ctypes.c_int] * 6
        scratch.restype = ctypes.c_longlong
        lib.repro_ring_decode_error_string.argtypes = [ctypes.c_int]
        lib.repro_ring_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, scratch, lib.repro_ring_decode_error_string)
    return _fn


@functools.lru_cache(maxsize=None)
def _ring_scratch_floats(*shape_and_dtype: int) -> int:
    """Floats of the partials scratch the ring kernel needs for (B, C, Hq,
    Hkv, Dh, dtype code): the library sizes its own split over slots (0
    in float32)."""
    return int(_kernel()[1](*shape_and_dtype))


def decode_attention(
    q: torch.Tensor,  # (B, Hq, Dh)
    k_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    v_cache: torch.Tensor,  # (B, C, Hkv, Dh)
    slot_pos: torch.Tensor,  # (B, C) int32, -1 == empty slot
    q_pos: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    mesh=None,
    axis: str = "model",
) -> torch.Tensor:
    """One new token per row over the ring cache; (B, Hq, Dh) in q's dtype."""
    if q.dim() == 3 and k_cache.dim() == 4 and heads_shardable(
            mesh, q.shape[1], k_cache.shape[2], axis):
        return _shard_map(decode_attention, mesh, axis, (q, k_cache, v_cache),
                          (slot_pos, q_pos),
                          dict(window=window, softcap=softcap))
    _unsharded("decode_attention", q)
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    B, Hq, Dh = q.shape
    _, C, Hkv, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != Dh or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(k_cache.shape)}")
    if tuple(slot_pos.shape) != (B, C) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"slot_pos {tuple(slot_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match ({B}, {C})")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, slot_pos, q_pos,
                                    window=window, softcap=softcap)
    if not on_card(q):
        raise ValueError(f"no decode_attention for device {q.device}")
    code = _build.dtype_code(q)
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {_build.HEAD_DIMS}")
    if Hq // Hkv > 32:
        raise ValueError(f"at most 32 q heads per kv head, got {Hq // Hkv}")
    if slot_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("slot_pos and q_pos must be int32")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_operand(name, t, q.device)
    for name, t in (("slot_pos", slot_pos), ("q_pos", q_pos)):
        _build.check_operand(name, t, q.device, align=4)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.is_meta:  # traced (analysis mode): no kernel
        return _ring_counted(out, C, Hkv)
    fn, _, err_str = _kernel()
    n_part = _ring_scratch_floats(B, C, Hq, Hkv, Dh, code)
    part = (torch.empty(n_part, dtype=torch.float32, device=q.device)
            if n_part else None)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            B, C, Hq, Hkv, Dh,
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            1.0 / Dh ** 0.5, code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"ring_decode launch failed: {err_str(err).decode()} ({err})"
        )
    return _ring_counted(out, C, Hkv)


def _ring_counted(out, C: int, Hkv: int):
    """Count one ``ring_decode`` call and report its cost from the shapes
    (every slot live)."""
    global launches
    B, Hq, Dh = out.shape
    launches += 1
    record_cost("ring_decode", ring_decode_cost, B, C, Hq, Hkv, Dh,
                out.element_size())
    return out


def _paged_kernel():
    global _paged_fn
    if _paged_fn is None:
        lib = _build.load("paged_attention")
        fn = lib.repro_paged_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        scratch = lib.repro_paged_attention_scratch_floats
        scratch.argtypes = [ctypes.c_int] * 8
        scratch.restype = ctypes.c_longlong
        lib.repro_paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.repro_paged_attention_error_string.restype = ctypes.c_char_p
        _paged_fn = (fn, scratch, lib.repro_paged_attention_error_string)
    return _paged_fn


@functools.lru_cache(maxsize=None)
def _paged_scratch_floats(*shape_and_dtype: int) -> int:
    """Floats of the partials scratch the paged kernel needs for (B, T,
    Hq, Hkv, Dh, page_size, Pmax, dtype code): the library sizes its own
    split over positions (0 in float32)."""
    return int(_paged_kernel()[1](*shape_and_dtype))


def head_subgroup(T: int, G: int) -> int:
    """G', the largest divisor of the group G with T · G' <= PAGED_ROWS:
    the query heads per kv head of one paged launch."""
    fits = [g for g in range(1, G + 1) if G % g == 0 and T * g <= PAGED_ROWS]
    if not fits:
        raise ValueError(f"at most {PAGED_ROWS} query tokens per sequence, "
                         f"got T={T}")
    return fits[-1]


def by_head_subgroups(fn: Callable, q: torch.Tensor, Hkv: int,
                      sub: int) -> torch.Tensor:
    """``fn`` on each sub-group of ``sub`` query heads per kv head of
    ``q`` (B, T, Hq, Dh): sub-group s of kv head j is heads
    ``j * G + s * sub ...``, gathered contiguous as (B, T, Hkv * sub, Dh);
    ``fn`` maps it to an output of that shape, which is scattered back
    into a (B, T, Hq, Dh) tensor."""
    B, T, Hq, Dh = q.shape
    G = Hq // Hkv
    if sub == G:
        return fn(q)
    out = torch.empty_like(q)
    qg, og = q.view(B, T, Hkv, G, Dh), out.view(B, T, Hkv, G, Dh)
    for s in range(0, G, sub):
        part = fn(qg[:, :, :, s:s + sub].reshape(B, T, Hkv * sub, Dh))
        og[:, :, :, s:s + sub] = part.view(B, T, Hkv, sub, Dh)
    return out


def paged_verify_attention(
    q: torch.Tensor,  # (B, T, Hq, Dh)
    k_pages: torch.Tensor,  # (P, page_size, Hkv, Dh), the whole pool
    v_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    block_tables: torch.Tensor,  # (B, Pmax) int32 page ids, -1 = unused
    lengths: torch.Tensor,  # (B,) int32 valid tokens incl. the T new ones
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    mesh=None,
    axis: str = "model",
) -> torch.Tensor:
    """T query tokens per sequence over a paged pool, causal within the
    speculation window; (B, T, Hq, Dh) in q's dtype.  The T new tokens'
    K/V must already sit in the pages the table maps.  The kernel reads
    the pool page-major with the table, with no gather copy.  On the card
    a ``length == 0`` row returns 0 (the Pallas kernel's behaviour); the
    plain version averages V there."""
    if q.dim() == 4 and k_pages.dim() == 4 and heads_shardable(
            mesh, q.shape[2], k_pages.shape[2], axis):
        return _shard_map(paged_verify_attention, mesh, axis,
                          (q, k_pages, v_pages), (block_tables, lengths),
                          dict(window=window, softcap=softcap))
    _unsharded("paged_verify_attention", q)
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}"
                         f", v {tuple(v_pages.shape)}")
    B, T, Hq, Dh = q.shape
    P, ps, Hkv, _ = k_pages.shape
    if k_pages.shape[3] != Dh or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(k_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={B}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if q.device.type == "cpu":
        return paged_verify_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths, window=window,
                                          softcap=softcap)
    if not on_card(q):
        raise ValueError(f"no paged_verify_attention for device {q.device}")
    code = _build.dtype_code(q)
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {_build.HEAD_DIMS}")
    sub = head_subgroup(T, Hq // Hkv)
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_operand(name, t, q.device)
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        _build.check_operand(name, t, q.device, align=4)
    if q.numel() == 0:
        return torch.empty_like(q)
    Pmax = block_tables.shape[1]
    if q.is_meta:  # traced (analysis mode): no kernel
        return _paged_counted(torch.empty_like(q), Hkv, ps, Pmax, window)
    fn, _, err_str = _paged_kernel()
    n_part = _paged_scratch_floats(B, T, Hkv * sub, Hkv, Dh, ps, Pmax, code)
    part = (torch.empty(n_part, dtype=torch.float32, device=q.device)
            if n_part else None)

    def launch(qs: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(qs)
        with torch.cuda.device(q.device):
            err = fn(
                qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None,
                B, T, qs.shape[2], Hkv, Dh, P, ps, Pmax,
                int(window) if window is not None else 0,
                float(softcap) if softcap is not None else 0.0,
                1.0 / Dh ** 0.5, code,
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"paged_attention launch failed: "
                               f"{err_str(err).decode()} ({err})")
        return out

    return _paged_counted(by_head_subgroups(launch, q, Hkv, sub), Hkv, ps,
                          Pmax, window)


def _paged_counted(out, Hkv: int, ps: int, Pmax: int, window):
    """Count one paged call and report its cost from the shapes (every
    row's table full)."""
    B, T, Hq, Dh = out.shape
    paged_launches[T] = paged_launches.get(T, 0) + 1
    record_cost("paged_attention", paged_cost, B, T, Hq, Hkv, Dh,
                out.element_size(), B * Pmax, [Pmax * ps] * B, window)
    return out


def paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, Dh)
    k_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    v_pages: torch.Tensor,  # (P, page_size, Hkv, Dh)
    block_tables: torch.Tensor,  # (B, Pmax) int32 page ids, -1 = unused
    lengths: torch.Tensor,  # (B,) int32 valid tokens incl. the current one
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    mesh=None,
    axis: str = "model",
) -> torch.Tensor:
    """One new token per sequence over a paged pool: the ``T == 1``
    launch of :func:`paged_verify_attention`; (B, Hq, Dh)."""
    if q.dim() == 3 and k_pages.dim() == 4 and heads_shardable(
            mesh, q.shape[1], k_pages.shape[2], axis):
        return _shard_map(paged_decode_attention, mesh, axis,
                          (q, k_pages, v_pages), (block_tables, lengths),
                          dict(window=window, softcap=softcap))
    _unsharded("paged_decode_attention", q)
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, Dh), got {tuple(q.shape)}")
    return paged_verify_attention(
        q[:, None], k_pages, v_pages, block_tables, lengths,
        window=window, softcap=softcap,
    )[:, 0]
