"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.  Nothing is built or loaded at import.

Each wrapper counts the calls that launched its kernel on the host.  A
CUDA graph breaks that count twice: its capture runs the wrappers (they
tick) but launches nothing, and its replay launches everything without
running them.  :func:`launch_counts` and :func:`add_launches` let the
graph machinery (:mod:`repro_torch.serving.jitcache`) take a capture's
ticks back out and add them again on every replay.

Each wrapper also has a cost function per launch, ``(flops, bytes)``:
the operations the launch's work needs and the bytes it must move (each
input read once, each output written once).  They are the roofline
bounds of ``chip_smoke.py``'s kernel phase, and inside
:func:`kernel_costs` every launch, real or traced
(:func:`repro_torch.device.analysis_mode`), reports its figures there
from its shapes alone: a key count it would have to read off the card
(``kv_len``, a ring's live slots) counts as full."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

Counts = Dict[Tuple, int]
Cost = Tuple[str, float, float]  # (kernel, flops, bytes)

# the innermost kernel_costs() sink: a plain global, not a ContextVar,
# because a backward pass on the card launches from autograd's device
# thread, which does not see the caller's context
_COSTS: Optional[List[Cost]] = None


@contextlib.contextmanager
def kernel_costs():
    """Collect ``(kernel, flops, bytes)`` of every launch made inside,
    from any thread (a backward pass's too)."""
    global _COSTS
    outer, got = _COSTS, []
    _COSTS = got
    try:
        yield got
    finally:
        _COSTS = outer


def record_cost(kernel: str, cost: Callable[..., Tuple[float, float]],
                *args, **kw) -> None:
    """Report one launch of ``kernel`` to the innermost
    :func:`kernel_costs`, if any (``cost(*args, **kw)`` is only called
    then): the one global read a launch makes for it."""
    sink = _COSTS
    if sink is not None:
        sink.append((kernel, *cost(*args, **kw)))


def _modules():
    # the wrappers import this package, so they are imported here lazily
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    return {"decode_attention": dops, "flash_attention": fops, "ssd": sops}


# every wrapper's plain integer count, and every count it keeps per key
# (paged calls by T, sharded calls by wrapper and Hkv, flash and SSD
# calls by their head count)
_INTS = (("decode_attention", "launches"), ("flash_attention", "launches"),
         ("flash_attention", "q_offset_launches"),
         ("flash_attention", "backward_launches"), ("ssd", "launches"),
         ("ssd", "backward_launches"))
_DICTS = (("decode_attention", "paged_launches"),
          ("decode_attention", "sharded_launches"),
          ("flash_attention", "head_launches"), ("ssd", "head_launches"))


def launch_counts() -> Counts:
    """Every wrapper's launch count, flat: ``(package, counter)`` or
    ``(package, counter, key)`` -> n, e.g. ``("decode_attention",
    "paged_launches", 1)`` for paged decode calls."""
    mods = _modules()
    out = {(m, name): getattr(mods[m], name) for m, name in _INTS}
    for m, name in _DICTS:
        for key, n in getattr(mods[m], name).items():
            out[(m, name, key)] = n
    return out


def launches_since(before: Counts) -> Counts:
    """The counts added since ``before`` (a :func:`launch_counts`),
    nonzero entries only."""
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)}


def add_launches(delta: Counts, times: int = 1) -> None:
    """Add ``times`` × ``delta`` (from :func:`launches_since`) to the
    counters."""
    mods = _modules()
    for k, n in delta.items():
        mod, name = mods[k[0]], k[1]
        if len(k) == 2:
            setattr(mod, name, getattr(mod, name) + times * n)
        else:
            counts = getattr(mod, name)
            counts[k[2]] = counts.get(k[2], 0) + times * n
