"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.  Nothing is built or loaded at import.

Each wrapper counts the calls that launched its kernel on the host.  A
CUDA graph breaks that count twice: its capture runs the wrappers (they
tick) but launches nothing, and its replay launches everything without
running them.  :func:`launch_counts` and :func:`add_launches` let the
graph machinery (:mod:`repro_torch.serving.jitcache`) take a capture's
ticks back out and add them again on every replay."""
from __future__ import annotations

from typing import Dict, Tuple

Counts = Dict[Tuple, int]


def _modules():
    # the wrappers import this package, so they are imported here lazily
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    return {"decode_attention": dops, "flash_attention": fops, "ssd": sops}


# every wrapper's plain integer count, and every count it keeps per key
# (paged calls by T, sharded calls by wrapper and Hkv)
_INTS = (("decode_attention", "launches"), ("flash_attention", "launches"),
         ("flash_attention", "q_offset_launches"), ("ssd", "launches"))
_DICTS = (("decode_attention", "paged_launches"),
          ("decode_attention", "sharded_launches"))


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
