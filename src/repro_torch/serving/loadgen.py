"""Open-loop load generation: latency-under-QPS sweeps without
coordinated omission.

A *closed-loop* driver waits for a response before sending the next
request, so a stalled server silently throttles its own load and the
measured latencies hide the queueing the stall caused (coordinated
omission).  An *open-loop* driver fires every arrival on the trace
clock regardless of completions — what a population of independent
users actually does — so saturation shows up as unbounded queueing
delay instead of vanishing load.

Three layers:

* :class:`OpenLoopDriver` — a minimal, backend-agnostic driver over a
  ``server(rid, t_fire) -> t_done`` callable.  ``open_loop=True`` fires
  at the scheduled trace time; ``open_loop=False`` is the deliberately
  coordinated foil (each arrival waits for the previous completion) so
  tests can demonstrate the omission it causes.  The simulator's
  :class:`~repro_torch.serving.cluster.PDCluster` event loop is open-loop by
  construction (arrivals are heap events at fixed trace times, never
  gated on completions); the regression tests in
  ``tests/test_loadgen.py`` pin both properties.
* :func:`qps_sweep` — run one scenario's trace across an RPS grid
  through the sim cluster, collecting latency percentiles, SLO
  attainment and energy per token per rate.
* :func:`detect_knee` / :func:`attainment_knee` — saturation-knee
  detection over a sweep: the largest distance below the chord for the
  convex latency takeoff (Kneedle-style), and the last rate that still
  holds an attainment floor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Generic open-loop driver
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LoadPoint:
    """One fired request: scheduled (trace clock) vs fired (driver
    clock) vs completed times.  ``latency_s`` is measured from the
    *scheduled* arrival — the only definition immune to coordinated
    omission."""

    rid: int
    scheduled_s: float
    fired_s: float
    done_s: float

    @property
    def latency_s(self) -> float:
        return self.done_s - self.scheduled_s

    @property
    def fire_lag_s(self) -> float:
        """How late the driver injected the arrival vs the trace clock
        (0 for a correct open-loop driver)."""
        return self.fired_s - self.scheduled_s


class OpenLoopDriver:
    """Fire arrivals against ``server(rid, t_fire) -> t_done``.

    The server callable owns its own state (queues, busy horizons); it
    returns the absolute completion time of the request fired at
    ``t_fire``.  With ``open_loop=True`` (default) every arrival fires
    exactly at its scheduled time.  With ``open_loop=False`` the driver
    reproduces the classic closed-loop mistake: arrival *i* fires at
    ``max(scheduled_i, done_{i-1})``.
    """

    def __init__(self, open_loop: bool = True):
        self.open_loop = open_loop

    def run(
        self,
        arrivals: Sequence[float],
        server: Callable[[int, float], float],
    ) -> List[LoadPoint]:
        if any(b < a for a, b in zip(arrivals, arrivals[1:])):
            raise ValueError("arrivals must be sorted")
        points: List[LoadPoint] = []
        prev_done = -math.inf
        for rid, sched in enumerate(arrivals):
            fired = (
                float(sched) if self.open_loop
                else max(float(sched), prev_done)
            )
            done = float(server(rid, fired))
            if done < fired:
                raise ValueError(
                    f"server finished request {rid} at {done} before "
                    f"it fired at {fired}"
                )
            prev_done = done
            points.append(LoadPoint(rid, float(sched), fired, done))
        return points


class FIFOServer:
    """Single FIFO queue with fixed service time — the M/D/1 test
    double.  ``stall_until_s`` holds the server busy from t=0 (a
    deliberately stalled backend for the omission regression)."""

    def __init__(self, service_s: float, stall_until_s: float = 0.0):
        self.service_s = service_s
        self.free_at = stall_until_s

    def __call__(self, rid: int, t_fire: float) -> float:
        start = max(t_fire, self.free_at)
        self.free_at = start + self.service_s
        return self.free_at


# ---------------------------------------------------------------------------
# Knee detection
# ---------------------------------------------------------------------------


def detect_knee(
    rates: Sequence[float],
    latencies: Sequence[float],
    min_rise: float = 2.0,
) -> Optional[float]:
    """Saturation knee of a latency-vs-offered-rate curve.

    Kneedle-style on the convex takeoff: normalize both axes to [0, 1]
    and return the rate maximizing ``x_norm - y_norm`` — the point of
    greatest distance *below* the chord, i.e. the last rate before the
    curve pulls away.  Returns ``None`` when the curve never rises
    ``min_rise``× over its minimum (no saturation in the swept range:
    reporting a knee there would be noise).
    """
    x = np.asarray(rates, dtype=float)
    y = np.asarray(latencies, dtype=float)
    if x.ndim != 1 or x.shape != y.shape or len(x) < 3:
        raise ValueError(
            f"need >= 3 aligned (rate, latency) points, got {len(x)}"
        )
    if np.any(np.diff(x) <= 0.0):
        raise ValueError("rates must be strictly increasing")
    base = float(y.min())
    if base <= 0.0 or float(y.max()) < min_rise * base:
        return None
    xn = (x - x[0]) / (x[-1] - x[0])
    yn = (y - y.min()) / (y.max() - y.min())
    # interior argmax: the endpoints are chord anchors, never knees
    i = 1 + int(np.argmax(xn[1:-1] - yn[1:-1]))
    return float(x[i])


def attainment_knee(
    rates: Sequence[float],
    attainments: Sequence[float],
    floor: float = 0.9,
) -> Optional[float]:
    """Last offered rate whose SLO attainment still meets ``floor``
    before the first sustained violation — None if the floor is never
    met, or never lost."""
    x = list(rates)
    a = list(attainments)
    if len(x) != len(a) or not x:
        raise ValueError("need aligned non-empty rate/attainment lists")
    last_ok: Optional[float] = None
    for r, v in zip(x, a):
        if v >= floor:
            last_ok = r
        else:
            return last_ok
    return None  # never violated inside the sweep: knee is beyond it


# ---------------------------------------------------------------------------
# Cluster QPS sweep
# ---------------------------------------------------------------------------


def qps_sweep(
    make_requests: Callable[[float], Sequence],
    run_cluster: Callable[[Sequence], "object"],
    rates: Sequence[float],
    slo_floor: float = 0.9,
    knee_metric: str = "ttft_p99_s",
) -> Dict[str, object]:
    """Latency-and-attainment-under-QPS sweep with knee detection.

    ``make_requests(rps)`` materializes the scenario's workload at one
    offered rate (trace rescaling — the shape survives, only the clock
    warps); ``run_cluster(requests)`` serves it open-loop and returns a
    :class:`~repro_torch.serving.metrics.RunMetrics`.  Returns per-rate rows
    plus ``knee_rps`` (latency takeoff) and ``attainment_knee_rps``
    (last rate holding ``slo_floor``).
    """
    rows: List[Dict[str, float]] = []
    for rps in rates:
        m = run_cluster(make_requests(float(rps)))
        ttft = m.ttft_values()
        itl = m.itl_values()
        rows.append({
            "rps": float(rps),
            "n_requests": len(m.requests),
            "finished_frac": round(m.finished_frac(), 4),
            "ttft_p50_s": round(float(np.median(ttft)), 4) if len(ttft)
            else math.inf,
            "ttft_p99_s": round(float(np.quantile(ttft, 0.99)), 4)
            if len(ttft) else math.inf,
            "itl_p99_s": round(float(np.quantile(itl, 0.99)), 5)
            if len(itl) else math.inf,
            "ttft_attain": round(m.ttft_attainment(), 4),
            "itl_attain": round(m.itl_attainment(), 4),
            "slo_attain": round(
                min(m.ttft_attainment(), m.itl_attainment()), 4
            ),
            "energy_per_token_mj": round(
                m.energy_per_token_j() * 1e3, 3
            ),
            "throughput_tok_s": round(m.throughput_tok_s(), 1),
        })
    rates_f = [r["rps"] for r in rows]
    return {
        "rows": rows,
        "knee_rps": detect_knee(
            rates_f, [r[knee_metric] for r in rows]
        ),
        "attainment_knee_rps": attainment_knee(
            rates_f, [r["slo_attain"] for r in rows], floor=slo_floor
        ),
        "knee_metric": knee_metric,
        "slo_floor": slo_floor,
    }
