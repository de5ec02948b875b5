"""EcoScale — SLO- and energy-aware fleet autoscaling (heterogeneous P/D).

VoltanaLLM's two levers (per-iteration DVFS and state-space routing) act
on a *fixed* fleet; under diurnal traffic the idle floor of over-provisioned
instances dominates trough-hour energy.  EcoScale adds the third lever:
per-phase elastic capacity over a possibly heterogeneous fleet.

* **Fleet description** — :class:`InstanceSpec` pins one slot to a chip
  (:class:`~repro.core.power.ChipSpec`), a TP degree, and a frequency
  ladder, so a cluster can mix e.g. A100- and GH200-class instances with
  distinct U-curves and ladders.
* **Headroom projection** — per autoscale tick the scaler projects each
  phase's load against its active capacity using EcoPred:

    - decode: each active instance's predicted ITL *at its max clock* as a
      fraction of the ITL SLO (waiting queue ⇒ saturated), summed over the
      fleet;
    - prefill: EWMA token arrival rate + queued backlog vs the fleet's
      EcoPred-projected max-clock token throughput.

* **Decisions** — if the projected per-instance load after removing one
  instance stays below ``util_park``, the *most expensive* active instance
  (highest reference J/token — heterogeneity-aware) drains: routers stop
  placing on it, in-flight work completes, then it parks at the chip's
  sleep draw.  If load exceeds ``util_hi`` (or decode queues form) a
  parked instance re-admits, cheapest chip first.  A per-phase cooldown
  prevents flapping.

The scaler piggybacks on the cluster's event loop (a recurring ``_SCALE``
event) and uses the same drain/park hooks the chaos machinery uses, so
fault injection composes: a parked instance that is killed simply stays
dead and is never re-admitted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from repro_torch.core.power import ChipSpec

if TYPE_CHECKING:
    from repro_torch.serving.cluster import PDCluster
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine


# ---------------------------------------------------------------------------
# Fleet description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InstanceSpec:
    """One fleet slot: chip type, TP degree, and frequency ladder."""

    chip: ChipSpec
    tp: int = 1
    freq_options: Optional[Tuple[float, ...]] = None  # None -> 2-level

    def freqs(self) -> Tuple[float, ...]:
        return tuple(self.freq_options or self.chip.freq_levels_2)

    @property
    def f_max(self) -> float:
        return max(self.freqs())

    @property
    def key(self) -> Tuple[str, int]:
        """Predictor/hardware-model sharing key."""
        return (self.chip.name, self.tp)


def homogeneous_fleet(
    chip: ChipSpec, n: int, tp: int = 1, freq_options=None
) -> List[InstanceSpec]:
    """Convenience: ``n`` identical slots (the pre-EcoScale fleet shape)."""
    fo = tuple(freq_options) if freq_options else None
    return [InstanceSpec(chip, tp, fo) for _ in range(n)]


# ---------------------------------------------------------------------------
# Autoscaler
# ---------------------------------------------------------------------------


@dataclass
class AutoScaleConfig:
    interval_s: float = 2.0  # projection/decision tick
    util_hi: float = 0.85  # re-admit above this projected load
    util_park: float = 0.60  # projected post-park load must stay below
    min_prefill: int = 1
    min_decode: int = 1
    cooldown_s: float = 6.0  # per-phase gap between parks (anti-flap)
    # once capacity was needed, hold it: no park within this window of the
    # phase's last re-admission (bursty peaks re-trigger immediately)
    park_holdoff_s: float = 24.0
    ewma_alpha: float = 0.5  # arrival-rate smoothing
    # prefill latency guard: re-admit when any active instance's projected
    # queue-drain time exceeds this fraction of the TTFT SLO
    ttft_pressure_frac: float = 0.5


@dataclass
class ScaleEvent:
    """One autoscaler decision, for observability and tests."""

    t: float
    phase: str  # "prefill" | "decode"
    action: str  # "park" | "readmit"
    idx: int


class AutoScaler:
    """Per-phase drain/park/re-admit controller over a PDCluster fleet."""

    def __init__(self, cfg: AutoScaleConfig, cluster: "PDCluster"):
        self.cfg = cfg
        self.cluster = cluster
        self.events: List[ScaleEvent] = []
        self._last_action = {"prefill": -1e18, "decode": -1e18}
        self._last_readmit = {"prefill": -1e18, "decode": -1e18}
        self._last_pressure = {"prefill": -1e18, "decode": -1e18}
        self._tok_rate_ewma = 0.0

    # -- public tick --------------------------------------------------------
    def step(self, now: float) -> None:
        cl = self.cluster
        rate = cl.pop_arrived_tokens() / max(self.cfg.interval_s, 1e-9)
        a = self.cfg.ewma_alpha
        self._tok_rate_ewma = a * rate + (1 - a) * self._tok_rate_ewma
        self._step_decode(now)
        self._step_prefill(now)
        # drained instances that have emptied enter the parked state
        for e in cl.prefill + cl.decode:
            if e.alive and not e.accepting:
                e.begin_park(now)

    # -- phase: decode ------------------------------------------------------
    def _decode_load(self, e: "DecodeEngine", spec: InstanceSpec) -> float:
        """Fraction of the ITL SLO the instance consumes at max clock."""
        u = 0.0
        if e.n_req > 0:
            t = float(
                e.predictor.predict_decode(spec.f_max, e.n_req, e.n_kv)[0]
            )
            u = t / self.cluster.cfg.slo_itl_s
        if e.waiting:
            u = max(u, 1.0)
        return min(u, 2.0)

    def _step_decode(self, now: float) -> None:
        cl, c = self.cluster, self.cfg
        alive = [e for e in cl.decode if e.alive]
        active = [e for e in alive if e.accepting]
        parked = [e for e in alive if not e.accepting]
        if not active:
            if parked:
                self._readmit("decode", parked, now)
            return
        total = sum(
            self._decode_load(e, cl.decode_specs[e.idx]) for e in active
        )
        pressure = any(e.waiting for e in active)
        if pressure:
            self._last_pressure["decode"] = now
        # fast out: SLO pressure re-admits immediately (no cooldown) —
        # slow in: parking waits out the cooldown + post-readmit hold-off
        if (total / len(active) > c.util_hi or pressure) and parked:
            self._readmit("decode", parked, now)
        elif (
            self._may_park("decode", now)
            and len(active) > c.min_decode
            and self._projected(total, len(active) - 1) < c.util_park
        ):
            self._park("decode", active, now)

    # -- phase: prefill -----------------------------------------------------
    def _prefill_capacity(
        self, e: "PrefillEngine", spec: InstanceSpec
    ) -> float:
        """EcoPred-projected max-clock prefill throughput (tokens/s)."""
        b = e.max_batch_tokens
        t = float(e.predictor.predict_prefill(spec.f_max, b)[0])
        return b / max(t, 1e-9)

    def _step_prefill(self, now: float) -> None:
        cl, c = self.cluster, self.cfg
        alive = [e for e in cl.prefill if e.alive]
        active = [e for e in alive if e.accepting]
        parked = [e for e in alive if not e.accepting]
        if not active:
            if parked:
                self._readmit("prefill", parked, now)
            return
        caps = {
            e.idx: self._prefill_capacity(e, cl.prefill_specs[e.idx])
            for e in active
        }
        backlog = sum(e.queued_tokens for e in active)
        demand = self._tok_rate_ewma + backlog / c.interval_s
        total_cap = sum(caps.values())
        # latency guard: throughput can look fine while a burst's queue
        # drain already projects past the TTFT budget
        pressure = any(
            self._queue_drain_s(e, cl.prefill_specs[e.idx], now)
            > c.ttft_pressure_frac * cl.cfg.slo_ttft_s
            for e in active
        )
        if pressure:
            self._last_pressure["prefill"] = now
        if (demand / total_cap > c.util_hi or pressure) and parked:
            self._readmit("prefill", parked, now)  # fast out
        elif (
            self._may_park("prefill", now)
            and len(active) > c.min_prefill
        ):
            victim = self._pick_park("prefill", active)
            remaining = total_cap - caps[victim.idx]
            if self._projected(demand, remaining) < c.util_park:
                self._do_park("prefill", victim, now)

    def _queue_drain_s(
        self, e: "PrefillEngine", spec: InstanceSpec, now: float
    ) -> float:
        """Projected TTFT of the last queued request: the in-flight
        batch's remaining time plus the EcoPred-projected queue drain at
        max clock."""
        t = max(0.0, e.busy_until - now) if e.busy else 0.0
        if e.queued_tokens:
            t += float(
                e.predictor.predict_prefill(spec.f_max, e.queued_tokens)[0]
            )
        return t

    @staticmethod
    def _projected(demand: float, capacity: float) -> float:
        """Post-park load projection; parking the last instance (min
        floor 0) is only fine when there is literally no demand."""
        if capacity <= 0.0:
            return 0.0 if demand <= 0.0 else float("inf")
        return demand / capacity

    # -- decisions ----------------------------------------------------------
    def _may_park(self, phase: str, now: float) -> bool:
        """Slow in: respect the park cooldown, and hold capacity while the
        phase re-admitted or saw SLO pressure within the hold-off window
        (mean-demand projections can't see burst latency)."""
        c = self.cfg
        return (
            now - self._last_action[phase] >= c.cooldown_s
            and now - self._last_readmit[phase] >= c.park_holdoff_s
            and now - self._last_pressure[phase] >= c.park_holdoff_s
        )

    def _rating(self, phase: str, e) -> float:
        """Reference J/token of the instance's chip (park expensive first,
        re-admit cheap first)."""
        hw = e.backend.hw
        return hw.prefill_ept_j() if phase == "prefill" else hw.decode_ept_j()

    def _load_n(self, e) -> int:
        return len(e.queue) if hasattr(e, "queue") else e.n_req

    def _pick_park(self, phase: str, active):
        # most expensive chip; tie-break least-loaded (fastest drain),
        # then highest idx (deterministic for homogeneous fleets)
        return max(
            active,
            key=lambda e: (self._rating(phase, e), -self._load_n(e), e.idx),
        )

    def _park(self, phase: str, active, now: float) -> None:
        self._do_park(phase, self._pick_park(phase, active), now)

    def _do_park(self, phase: str, victim, now: float) -> None:
        victim.drain()
        victim.begin_park(now)
        self.events.append(ScaleEvent(now, phase, "park", victim.idx))
        self._last_action[phase] = now

    def _readmit(self, phase: str, parked, now: float) -> None:
        pick = min(parked, key=lambda e: (self._rating(phase, e), e.idx))
        pick.readmit(now)
        self.cluster.on_readmit(phase, pick)
        self.events.append(ScaleEvent(now, phase, "readmit", pick.idx))
        self._last_action[phase] = now
        self._last_readmit[phase] = now

    # -- event-driven pressure wake (called from the routing hot path) ------
    def maybe_wake_prefill(self, now: float, prompt_len: int) -> None:
        """Re-admit a parked prefill instance *immediately* when every
        active instance's projected TTFT for this arrival already blows
        the pressure budget — bursts land between ticks, and a 2 s
        reaction lag is most of a 600 ms TTFT SLO."""
        cl, c = self.cluster, self.cfg
        parked = [e for e in cl.prefill if e.alive and not e.accepting]
        if not parked:
            return
        active = [e for e in cl.prefill if e.alive and e.accepting]
        budget = c.ttft_pressure_frac * cl.cfg.slo_ttft_s

        def projected_ttft(e) -> float:
            # in-flight batch + existing queue + the arriving prompt itself
            spec = cl.prefill_specs[e.idx]
            t = max(0.0, e.busy_until - now) if e.busy else 0.0
            t += float(
                e.predictor.predict_prefill(
                    spec.f_max, e.queued_tokens + prompt_len
                )[0]
            )
            return t

        if not active or all(projected_ttft(e) > budget for e in active):
            self._last_pressure["prefill"] = now
            self._readmit("prefill", parked, now)

    def maybe_wake_decode(self, now: float, prompt_len: int) -> None:
        """Decode twin: wake a parked instance when no active instance is
        projected to absorb the request within the ITL SLO at max clock."""
        cl = self.cluster
        parked = [e for e in cl.decode if e.alive and not e.accepting]
        if not parked:
            return
        active = [e for e in cl.decode if e.alive and e.accepting]
        slo = cl.cfg.slo_itl_s

        def absorbs(e) -> bool:
            if e.waiting:
                return False
            spec = cl.decode_specs[e.idx]
            t = float(
                e.predictor.predict_decode(
                    spec.f_max, e.n_req + 1, e.n_kv + prompt_len
                )[0]
            )
            return t <= slo

        if not active or not any(absorbs(e) for e in active):
            self._last_pressure["decode"] = now
            self._readmit("decode", parked, now)

    # -- observability ------------------------------------------------------
    def n_events(self, phase: str = None, action: str = None) -> int:
        return sum(
            1
            for ev in self.events
            if (phase is None or ev.phase == phase)
            and (action is None or ev.action == action)
        )
