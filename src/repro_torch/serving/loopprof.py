"""Event-loop time-split instrumentation (opt-in, zero cost when off).

``install(cluster)`` wraps a :class:`~repro_torch.serving.cluster.PDCluster`'s
engines and routers with ``perf_counter`` accounting and returns a
:class:`LoopProfile`; run the workload, then read ``profile.breakdown()``
for the per-phase wall split the benchmark harness publishes in
``BENCH_serving.json``:

* ``schedule`` — engine ``start_iteration`` minus its inner EcoFreq and
  backend shares: batch assembly, admission, chunk take selection.
* ``select``   — EcoFreq frequency-ladder scans (``controller.select``).
* ``route``    — router placement decisions (``Router.route`` on the
  cluster's prefill/decode routers).  The cluster's ``_route_*``
  wrappers are deliberately NOT the probe point: they also kick idle
  engines, whose iteration time is already accounted under
  schedule/select/dispatch — timing them here double-counted that work
  as routing.
* ``dispatch`` — backend iteration calls' host time (Sim: hwmodel
  pricing; Real: jit dispatch — *not* device completion, which the async
  backend defers).
* ``device_wait`` — host time truly blocked on device transfers (real
  backends' deferred-emission drains; 0 in pure simulation).
* ``metrics``  — ``finish_iteration`` bookkeeping + straggler-bias
  re-prediction at ``_D_DONE``.
* ``queue``    — event-heap pops (the loop's only unavoidable
  per-event cost; pushes land under the handler that issued them).
* ``bookkeeping`` — per-event handler wall *not* covered by the probes
  above: routing wrappers' kick logic, request lifecycle mutation,
  chaos/scale handling, heap pushes.  Round 3 made this measurable so
  the unaccounted residue is timer overhead, not folklore.

Decision-plane telemetry (round 2) rides along in the same dict:

* ``select_memo_hit_rate`` — fraction of ``controller.select`` calls
  answered from the quantized-state memo (aggregated over every
  instrumented controller, unwrapping ``IntervalFreq``).
* ``route_batch_rows_avg`` — mean what-if rows per batched predictor
  matrix call across the routers (1.0 means no batching was possible).
* ``pipeline_depth_avg`` — mean async-dispatch ring occupancy observed
  at dispatch across real backends (0 for pure simulation, which has
  nothing in flight).

Engines created *after* ``install`` (autoscaler / chaos scale-out) are
instrumented too: the installer registers itself on the cluster's
``_spawn_hooks``, so mid-run spawns get the same wrapping and the
breakdown's ``accounted_frac`` stays honest.  Wrapping costs a couple of
``perf_counter`` calls per iteration, so install it for breakdown runs,
not for the headline iterations/s row.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List


@dataclass
class LoopProfile:
    start_total_s: float = 0.0
    select_s: float = 0.0
    backend_s: float = 0.0
    finish_total_s: float = 0.0
    route_s: float = 0.0
    queue_s: float = 0.0        # event-heap pops (profiled drain)
    bookkeeping_s: float = 0.0  # handler wall minus the probes above
    iterations: int = 0
    _engines: List = field(default_factory=list)   # live, grows on spawn
    _backends: List = field(default_factory=list)  # live, grows on spawn
    _routers: List = field(default_factory=list)

    def _device_wait(self) -> float:
        return sum(
            getattr(b, "device_wait_s", 0.0) for b in self._backends
        )

    def _select_memo_rate(self) -> float:
        hits = misses = 0
        for eng in self._engines:
            c = getattr(eng, "controller", None)
            c = getattr(c, "base", c)  # IntervalFreq wraps the memo owner
            hits += getattr(c, "select_memo_hits", 0)
            misses += getattr(c, "select_memo_misses", 0)
        return hits / (hits + misses) if hits + misses else 0.0

    def _route_batch_avg(self) -> float:
        queries = rows = 0
        for r in self._routers:
            queries += getattr(r, "route_batch_queries", 0)
            rows += getattr(r, "route_batch_rows", 0)
        return rows / queries if queries else 0.0

    def _pipeline_depth_avg(self) -> float:
        n = sum(
            getattr(b, "pipeline_dispatches", 0) for b in self._backends
        )
        s = sum(
            getattr(b, "pipeline_depth_sum", 0) for b in self._backends
        )
        return s / n if n else 0.0

    def breakdown(self, wall_s: float = 0.0) -> Dict[str, float]:
        dev = self._device_wait()
        out = {
            "schedule_s": max(
                0.0, self.start_total_s - self.select_s - self.backend_s
            ),
            "select_s": self.select_s,
            "route_s": self.route_s,
            "dispatch_s": max(0.0, self.backend_s - dev),
            "device_wait_s": dev,
            "metrics_s": self.finish_total_s,
            "queue_s": self.queue_s,
            "bookkeeping_s": self.bookkeeping_s,
            "iterations": self.iterations,
            "select_memo_hit_rate": self._select_memo_rate(),
            "route_batch_rows_avg": self._route_batch_avg(),
            "pipeline_depth_avg": self._pipeline_depth_avg(),
        }
        if wall_s > 0:
            out["wall_s"] = wall_s  # denominator for phase *shares*
            out["accounted_frac"] = round(
                (out["schedule_s"] + out["select_s"] + out["route_s"]
                 + out["dispatch_s"] + out["device_wait_s"]
                 + out["metrics_s"] + out["queue_s"]
                 + out["bookkeeping_s"]) / wall_s, 4,
            )
        return {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in out.items()
        }


_BACKEND_ITERS = (
    "prefill_iter", "prefill_chunk", "decode_iter", "spec_decode_iter",
    "hybrid_iter",
)


def install(cluster) -> LoopProfile:
    """Wrap the cluster's engines/routers in place; returns the profile
    the wrappers accumulate into.  Registers on the cluster's
    ``_spawn_hooks`` so engines spawned mid-run (scale-out) are wrapped
    identically."""
    prof = LoopProfile()

    def timed(fn, attr, count=False):
        def wrapper(*a, **k):
            t0 = perf_counter()
            try:
                return fn(*a, **k)
            finally:
                setattr(prof, attr, getattr(prof, attr)
                        + perf_counter() - t0)
                if count:
                    prof.iterations += 1
        return wrapper

    def instrument(eng):
        eng.start_iteration = timed(eng.start_iteration, "start_total_s")
        eng.finish_iteration = timed(eng.finish_iteration,
                                     "finish_total_s")
        eng.controller.select = timed(eng.controller.select, "select_s")
        for name in _BACKEND_ITERS:
            if hasattr(eng.backend, name):
                setattr(eng.backend, name,
                        timed(getattr(eng.backend, name), "backend_s",
                              count=True))
        prof._engines.append(eng)
        prof._backends.append(eng.backend)

    for eng in (list(cluster.prefill) + list(cluster.decode)
                + list(cluster.hybrid)):
        instrument(eng)
    cluster.prefill_router.route = timed(cluster.prefill_router.route,
                                         "route_s")
    cluster.decode_router.route = timed(cluster.decode_router.route,
                                        "route_s")
    hooks = getattr(cluster, "_spawn_hooks", None)
    if hooks is not None:
        hooks.append(instrument)
    prof._routers = [cluster.prefill_router, cluster.decode_router]
    # the cluster's run loop switches to its profiled drain (heap-pop +
    # per-event residue timing) when a profile is attached
    cluster._prof = prof
    return prof
