"""Per-instance mesh slices: the world's ranks carved into TP sub-meshes.

Counterpart of ``repro/distributed/meshslice.py``.  A serving instance
(``InstanceSpec.tp``) is a *slice*: a ``(1, tp)`` ``DeviceMesh`` with
axes ``("data", "model")`` over ``tp`` ranks of the
``torch.distributed`` world, the axis names the sharding rules speak
(:mod:`repro_torch.distributed.sharding`).  :class:`MeshSlicer` hands
slices out round-robin from the world, and restarts at rank 0 when the
next slice would straddle the end of the pool, so later slices share
ranks — on a world of ``tp`` ranks every instance lands on the same
ranks, which is the case the port serves (the P→D handoff is then
shard-local).

Every rank builds every slice, in the same order: creating a
``DeviceMesh`` creates process groups, which is collective over the
world.  The ranks of a mesh must be increasing, so that a rank's
coordinate on ``"model"`` is its rank in the axis's process group (the
order ``all_gather`` concatenates in).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_slice_mesh(ranks: Sequence[int], device_type: str) -> DeviceMesh:
    """A ``(1, tp)`` ("data", "model") mesh over ``ranks``."""
    ranks = [int(r) for r in ranks]
    if not ranks or ranks != sorted(set(ranks)):
        raise ValueError(f"a slice needs increasing ranks, got {ranks}")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(1, len(ranks)),
                      mesh_dim_names=("data", "model"))


class MeshSlicer:
    """Carves tp-wide ("data", "model") sub-meshes from a pool of ranks.

    ``devices=None`` takes every rank of the initialized world.  Slices
    are handed out round-robin: disjoint while ranks remain, restarting
    at the first rank when the next slice would straddle the end.  A
    slice over ranks already sliced is the same ``DeviceMesh`` object
    (no new process groups).
    """

    def __init__(self, devices: Optional[Sequence[int]] = None,
                 device_type: str = "cuda"):
        if devices is None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "MeshSlicer(devices=None) slices the torch.distributed "
                    "world; join one first (repro_torch.distributed."
                    "init_world) or pass the ranks"
                )
            devices = range(dist.get_world_size())
        self.devices: List[int] = [int(d) for d in devices]
        if not self.devices:
            raise ValueError("MeshSlicer needs at least one device")
        self.device_type = device_type
        self._next = 0
        self._meshes: Dict[Tuple[int, ...], DeviceMesh] = {}

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def take(self, tp: int) -> List[int]:
        """The ranks of the next tp-wide slice (raises ``ValueError`` when
        ``tp`` is below 1 or exceeds the pool)."""
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        n = len(self.devices)
        if tp > n:
            raise ValueError(
                f"tp={tp} exceeds the {n} available devices — shrink tp, or "
                "start a world with more ranks"
            )
        start = self._next
        if start + tp > n:  # don't straddle the end of the pool: restart
            start = 0
        self._next = (start + tp) % n
        return self.devices[start: start + tp]

    def slice(self, tp: int) -> DeviceMesh:
        """The next tp-wide slice, as a ``DeviceMesh``."""
        ranks = tuple(self.take(tp))
        if ranks not in self._meshes:
            self._meshes[ranks] = make_slice_mesh(ranks, self.device_type)
        return self._meshes[ranks]
