"""Collective traffic of a traced rank program.

Counterpart of ``repro/distributed/hloanalysis.py``.  The JAX dry-run
parses the compiled, SPMD-partitioned HLO text, because GSPMD inserts
the collectives.  The port's collectives are explicit
(``distributed/context.py`` ``reduce_model``, ``gather_model``), so its
"HLO" is the record of the ``c10d`` ops a rank's step issued while
:mod:`repro_torch.launch.dryrun` traced it: each op under the HLO name
of what it does, with its result bytes (:func:`c10d_entry`).

The reference's while-loop scaling is not needed: an eager trace runs
every layer, so a collective inside the loop over blocks is recorded
once per block (and the reference's unscaled ``collective_bytes_flat``
would be the same sum).

Wire factors (estimated per-device wire volume per op), as the
reference's: all-gather ≈ result bytes (what a device must receive);
all-reduce ≈ 2× (ring reduce-scatter + all-gather); reduce-scatter /
all-to-all / collective-permute ≈ result bytes once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

_WIRE_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d op (its name without the namespace and overload) -> HLO name
_C10D_OPS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}

Entry = Tuple[str, int]  # (op, result bytes)


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    if hasattr(x, "untyped_storage"):
        return x.numel() * x.element_size()
    return 0


def c10d_entry(func, args) -> Optional[Entry]:
    """The record entry of one dispatched op: ``(HLO op name, result
    bytes)`` for a ``c10d`` collective (its first argument holds its
    results: the in-place tensors of an all-reduce, a gather's outputs),
    None for any other op.  A ``c10d`` op without an HLO counterpart
    (a barrier, a broadcast) keeps its own name."""
    if func.namespace != "c10d":
        return None
    name = func.__name__.split(".")[0]
    return _C10D_OPS.get(name, name), _nbytes(args[0]) if args else 0


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    def summary(self) -> Dict[str, float]:
        out = {f"{k}_GB": round(v / 1e9, 4) for k, v in
               sorted(self.bytes_by_op.items())}
        out["total_GB"] = round(self.total_bytes / 1e9, 4)
        return out


def collective_bytes(record: Iterable[Entry]) -> CollectiveStats:
    """Per-device estimated wire bytes and calls of a rank's recorded
    collectives (:func:`c10d_entry`), by op."""
    by: Dict[str, float] = {}
    cnt: Dict[str, int] = {}
    for op, nbytes in record:
        by[op] = by.get(op, 0.0) + nbytes * _WIRE_FACTOR.get(op, 1.0)
        cnt[op] = cnt.get(op, 0) + 1
    return CollectiveStats(by, cnt)
