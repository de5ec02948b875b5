"""Mesh context, the world of ranks, and the model's two collectives.

Counterpart of ``repro/distributed/context.py``.  Model code never holds
a mesh: it consults this context, and outside any mesh the helpers say
"no mesh" and the model runs meshless (one device, no collective).

The JAX package is single-controller: one process drives every device
of a slice, and GSPMD inserts the collectives.  The port runs SPMD, as
SGLang runs tensor parallelism: one process per rank, every rank running
the same control plane (it is seeded and never reads token content, so
every rank takes the same decisions) and holding only its local shards.
The model makes its collectives explicit on the slice's ``"model"``
group through :func:`reduce_model` and :func:`gather_model`.
:func:`init_world` sets that world up.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

MODEL_AXIS = "model"  # the slice axis tensor parallelism shards over

_ACTIVE: ContextVar[Optional[Tuple[object, dict]]] = ContextVar(
    "repro_torch_mesh", default=None
)


@contextlib.contextmanager
def mesh_context(mesh):
    """Run model code on ``mesh`` (a ``DeviceMesh`` slice): its axis
    names and sizes become visible to the helpers below."""
    token = _ACTIVE.set((mesh, dict(zip(mesh.mesh_dim_names, mesh.shape))))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`mesh_context`, or None."""
    active = _ACTIVE.get()
    return active[0] if active is not None else None


def active_axes() -> Optional[Tuple[str, ...]]:
    active = _ACTIVE.get()
    return tuple(active[1]) if active is not None else None


def has_axis(name: str) -> bool:
    active = _ACTIVE.get()
    return active is not None and name in active[1]


def axis_size(name: str) -> int:
    active = _ACTIVE.get()
    return active[1].get(name, 1) if active is not None else 1


def model_width(mesh, axis: str = MODEL_AXIS) -> int:
    """Width of ``mesh``'s ``axis`` (1 without a mesh or that axis)."""
    if mesh is None:
        return 1
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1)


def heads_shardable(mesh, hq: int, hkv: int, axis: str = MODEL_AXIS) -> bool:
    """Whether a layer's attention runs on split heads over ``axis``:
    the axis is wider than 1 and divides both Hq and Hkv
    (``repro/kernels/decode_attention/ops.py:43``).  The one rule for
    the decode-attention wrappers, the parameter and cache placements
    and the model's local head counts; otherwise the layer's attention
    weights and KV cache stay whole on every rank."""
    n = model_width(mesh, axis)
    return n > 1 and hq % n == 0 and hkv % n == 0


def model_rank() -> int:
    """This rank's coordinate on the active mesh's model axis: the
    index of the shard it holds (0 outside a mesh)."""
    mesh = current_mesh()
    return mesh.get_local_rank(MODEL_AXIS) if mesh is not None else 0


# ---------------------------------------------------------------------------
# The world of ranks
# ---------------------------------------------------------------------------


def pick_backend(device_type: str, world_size: int) -> str:
    """``nccl`` when every rank has a card of its own; ``gloo`` on the
    CPU, and when ranks share a card (NCCL refuses two ranks on one
    device)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_world(rank: int, world_size: int, init_method: str,
               device_type: str = "cuda", timeout_s: float = 120.0) -> str:
    """Join a ``world_size``-rank process group as ``rank`` and return the
    backend :func:`pick_backend` chose.  On CUDA a rank takes card
    ``rank % device_count``.  ``timeout_s`` bounds every collective, so
    a rank whose peer died fails instead of hanging."""
    backend = pick_backend(device_type, world_size)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=timeout_s),
    )
    return backend


# ---------------------------------------------------------------------------
# The model's collectives (on the active mesh's model-axis group)
# ---------------------------------------------------------------------------


def _sharding_mesh():
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            "the weights are shards of a mesh slice: run the model inside "
            "repro_torch.distributed.mesh_context(mesh) of that slice"
        )
    return mesh


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ``"model"`` axis, in place: the row-parallel
    outputs (``wo``, ``w_out``) and the vocab-parallel embedding."""
    dist.all_reduce(x, group=_sharding_mesh().get_group(MODEL_AXIS))
    return x


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ``"model"`` axis's shards of ``x``, concatenated along ``dim``
    in shard order: the vocabulary shards of the logits."""
    mesh = _sharding_mesh()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(model_width(mesh))]
    dist.all_gather(parts, x, group=mesh.get_group(MODEL_AXIS))
    return torch.cat(parts, dim=dim)
