"""Process-wide shared entry points of the real backend, with the
compile telemetry the cluster reports.

Counterpart of ``repro/serving/jitcache.py``.  PyTorch runs eagerly, so
there is no executable to cache: what the JAX package counts as a
compile — the first call of an entry point at a new input shape — is
recorded here as a first-seen ``(entry, cfg, statics, shape bucket)``
key.  :func:`compile_count` is the number of such keys, so it rises
exactly where the JAX backend would trace and compile, and a second run
over the same shapes adds 0 (the contract ``RunMetrics.recompiles``
pins).  Two backends with the same config get the *same* entry callable
from :func:`shared_entry`, as they share one jit in the JAX package.

**Mesh identity is part of the key**, as in the JAX package: an entry
point on a mesh slice runs inside
:func:`repro_torch.distributed.context.mesh_context` and keys on
:func:`mesh_fingerprint`, so two slices over the same ranks share an
entry while a meshless backend and a sliced one never do.  (The JAX key
also holds the sharding policy; the port's serving policy has no
fields.)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Set

from repro_torch.distributed.context import mesh_context

_ENTRIES: Dict[tuple, Callable] = {}  # entry key -> handed-out callable
_SEEN: Set[tuple] = set()  # (entry key, shape signature) first seen


def _signature(x) -> tuple:
    """Hashable shape bucket of a call's arguments: arrays contribute
    shape and dtype (as a jit's abstract signature), containers recurse,
    anything else contributes its type only.  Duck-typed, so the control
    plane that reads the counter never imports torch."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return (type(x).__name__,)


def mesh_fingerprint(mesh) -> Optional[tuple]:
    """Hashable identity of a mesh slice: axis names, axis sizes, the
    concrete ranks and the device type.  Two slices over the same ranks
    with the same axes are interchangeable; ``None`` stays ``None``."""
    if mesh is None:
        return None
    return (
        tuple(mesh.mesh_dim_names),
        tuple(mesh.shape),
        tuple(int(r) for r in mesh.mesh.flatten().tolist()),
        mesh.device_type,
    )


def shared_entry(fn: Callable, cfg, *, mesh=None, **statics) -> Callable:
    """The process-wide entry point for ``fn`` closed over ``cfg`` (and
    any keyword ``statics``).  Idempotent: same key -> same callable.
    Each call records its shape signature (the params argument, fixed by
    ``cfg``, is left out) and then runs ``fn`` eagerly; with ``mesh``,
    inside that slice's mesh context."""
    key = (fn, cfg, tuple(sorted(statics.items())), mesh_fingerprint(mesh))
    entry = _ENTRIES.get(key)
    if entry is not None:
        return entry

    def entry(params, **kwargs):
        _SEEN.add((key, _signature(kwargs)))
        if mesh is None:
            return fn(params, cfg=cfg, **statics, **kwargs)
        with mesh_context(mesh):
            return fn(params, cfg=cfg, **statics, **kwargs)

    _ENTRIES[key] = entry
    return entry


def compile_count() -> int:
    """Distinct (entry point, shape bucket) pairs called so far — what
    the JAX backend would have compiled."""
    return len(_SEEN)


def entry_count() -> int:
    """Number of distinct shared entry points (for telemetry/tests)."""
    return len(_ENTRIES)


def clear() -> None:
    """Forget every entry point and every shape seen (tests use this to
    measure cold-start behaviour)."""
    _ENTRIES.clear()
    _SEEN.clear()
