"""Production meshes over a fake world: the dry-run's 256 and 512 ranks
on one host with no card.

Counterpart of ``repro/launch/mesh.py``.  The JAX package builds its
production meshes from 512 placeholder host devices; the port's mesh is
a ``DeviceMesh`` over a ``torch.distributed`` world, so the dry-run
builds one over a *fake* process group (backend ``"fake"``: every
collective returns at once and moves nothing), traced as one rank.  The
world is global state, so :func:`fake_world` (and
:func:`make_production_mesh`, which opens one) destroys it on exit: no
later code in the process inherits it (``MeshSlicer(devices=None)``
reads ``dist.is_initialized()``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the mesh's own device type: its process groups carry no tensors of the
# card's, only the traced ones of repro_torch.device.ANALYSIS_DEVICE
MESH_DEVICE_TYPE = "cpu"


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A ``world_size``-rank world of the fake backend, this process its
    rank 0 (the rank the dry-run traces); destroyed on exit.  Refuses to
    stack on a live world."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already live; the "
                           "dry-run's fake world would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the first ranks of the live
    world, in row-major order (the last axis fastest, as
    ``jax.make_mesh`` lays devices out)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(f"a {shape} mesh needs a world of {n} ranks "
                           "(fake_world)")
    return DeviceMesh(MESH_DEVICE_TYPE, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of a production mesh: one pod is (16, 16) data x
    model = 256 chips; multi-pod adds a leading "pod" axis, 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False) -> Iterator[DeviceMesh]:
    """The production mesh over a fake world of its size, this process
    its rank 0; the world is destroyed on exit."""
    shape, axes = production_shape(multi_pod)
    with fake_world(math.prod(shape)):
        yield make_mesh(shape, axes)
