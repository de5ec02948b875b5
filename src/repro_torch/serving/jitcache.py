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

**Step graphs.**  Where the JAX backend replays a compiled executable,
the port replays a CUDA graph: :class:`StepGraph` captures a backend's
decode-shaped steps, one graph per entry and shape signature.  Unlike an
executable, a graph belongs to one backend (see the class).  Counting
stays as it was: :func:`compile_count` still counts first-seen keys,
:func:`capture_count` and :func:`replay_count` count graphs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set

from repro_torch import kernels
from repro_torch.distributed.context import mesh_context

_ENTRIES: Dict[tuple, Callable] = {}  # entry key -> handed-out callable
_SEEN: Set[tuple] = set()  # (entry key, shape signature) first seen
_GRAPHS = {"captures": 0, "replays": 0}  # process-wide graph telemetry


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


def capture_count() -> int:
    """CUDA graphs captured so far, over every backend."""
    return _GRAPHS["captures"]


def replay_count() -> int:
    """CUDA graph replays so far, over every backend."""
    return _GRAPHS["replays"]


def clear() -> None:
    """Forget every entry point and every shape seen, and zero the graph
    counts (tests use this to measure cold-start behaviour).  Graphs
    themselves belong to their backends."""
    _ENTRIES.clear()
    _SEEN.clear()
    _GRAPHS.update(captures=0, replays=0)


def graphs_available(device) -> bool:
    """Whether steps on ``device`` can be captured: on the card only."""
    return device.type == "cuda"


def _capture(fn: Callable, params, kwargs: Dict[str, Any], pool):
    """Capture ``fn(params, **kwargs)`` into a CUDA graph, on the graph's
    own stream, with its memory from ``pool`` (None: a new pool).
    Returns ``(graph, outputs)``: ``graph.replay()`` launches the
    captured work on the current stream, ``graph.pool()`` names its pool,
    and ``outputs`` is the call's return value, whose tensors every
    replay rewrites in place.  Capture launches nothing."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outputs = fn(params, **kwargs)
    return graph, outputs


def _leaf_ptrs(tree) -> tuple:
    if isinstance(tree, dict):
        return tuple(_leaf_ptrs(v) for _, v in sorted(tree.items()))
    return tree.data_ptr()


class _Captured:
    """One captured step: its graph, static input buffers, outputs and
    the launch counts its replay stands for."""

    def __init__(self, fn, params, kwargs, device, pool):
        import torch

        self.params = params
        self.inputs = {}  # name -> static buffer the graph reads
        static = {}
        for name, v in kwargs.items():
            if isinstance(v, torch.Tensor):
                buf = torch.empty(v.shape, dtype=v.dtype, device=device)
                buf.copy_(v)
                self.inputs[name] = static[name] = buf
            else:
                static[name] = v
        # trees (the cache) are updated in place: a replay writes where
        # the capture saw them, so they must not move
        self.trees = {name: _leaf_ptrs(v) for name, v in kwargs.items()
                      if isinstance(v, dict)}
        before = kernels.launch_counts()
        self.graph, self.outputs = _capture(fn, params, static, pool)
        # the wrappers ticked during the capture, which launched nothing:
        # take those ticks out, and add them at every replay
        self.launches = kernels.launches_since(before)
        kernels.add_launches(self.launches, -1)

    def replay(self, params, kwargs):
        import torch

        if params is not self.params:
            raise RuntimeError("a step graph replays on the params it was "
                               "captured with")
        for name, ptrs in self.trees.items():
            if _leaf_ptrs(kwargs[name]) != ptrs:
                raise RuntimeError(f"a step graph's {name!r} moved since "
                                   "its capture")
        for name, buf in self.inputs.items():
            buf.copy_(kwargs[name])
        self.graph.replay()
        kernels.add_launches(self.launches)
        _GRAPHS["replays"] += 1
        # the next replay rewrites these buffers; the caller may keep the
        # ids of earlier steps (pipelined emission, the drafter's k runs)
        return tuple(o.clone() if isinstance(o, torch.Tensor) else o
                     for o in self.outputs)


class StepGraph:
    """A backend's CUDA graphs of its decode-shaped steps: one per entry
    point and shape signature, all in one memory pool.

    The port's counterpart of the JAX backend's jitted step executables,
    with one difference: a graph bakes in the addresses of its backend's
    params, cache and static input buffers, so it belongs to that
    backend.  Two backends that share an entry (and, in the JAX package,
    its executable) capture a graph each; the graphs share no memory and
    die with the backend.  Its graphs never run concurrently, so they
    share one pool.

    The first call at a key runs the step eagerly: it is the real step,
    and it also warms cuBLAS and sets each kernel's shared-memory opt-in.
    The step is captured right after; capture executes nothing, so the
    cache is written once (the Mamba2 step is not idempotent).  Every
    later call copies its tensor arguments into the graph's buffers on
    the current stream, in order behind the previous replay (a copy from
    host memory returns when done, so the caller may change its array
    at once), then replays, and returns clones of the outputs.  A dict
    argument (a cache) is updated in place and returned as itself; it
    must hold the same tensors at every replay.  A capture or replay
    that fails raises: nothing falls back to eager."""

    def __init__(self, device):
        self.device = device
        self._graphs: Dict[tuple, _Captured] = {}
        self._pool = None

    def __call__(self, entry: Callable, params, **kwargs):
        import torch

        key = (entry, _signature(kwargs))
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay(params, kwargs)
        out = entry(params, **{
            k: v.to(self.device) if isinstance(v, torch.Tensor) else v
            for k, v in kwargs.items()})
        graph = _Captured(entry, params, kwargs, self.device, self._pool)
        self._pool = graph.graph.pool()
        self._graphs[key] = graph
        _GRAPHS["captures"] += 1
        return out
