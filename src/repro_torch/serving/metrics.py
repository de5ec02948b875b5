"""Serving metrics: TTFT / ITL SLO attainment, energy, EPOT, throughput.

SLO attainment follows DistServe (paper §VI-A): the percentage of finished
requests with TTFT <= S_P and mean ITL <= S_D respectively — with SLO
tiers resolved, each request is judged against its *own* per-tier targets
(identical to the run-level SLOs for untiered workloads). Energy is the
paper's end-to-end Joules integrated over every instance (busy + idle);
``tier_summary`` splits attainment per tier and attributes energy by
output-token share.  Requests rejected by admission control (phase SHED)
were never admitted: they are excluded from attainment denominators and
reported via ``shed_frac``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclass
class InstanceEnergy:
    """Per-instance energy/time bookkeeping."""

    name: str
    busy_s: float = 0.0
    busy_j: float = 0.0
    span_s: float = 0.0  # wall-clock span the instance was alive
    idle_power_w: float = 0.0
    parked_s: float = 0.0  # time spent parked by the autoscaler
    sleep_power_w: float = 0.0  # draw while parked
    freq_trace: List[tuple] = field(default_factory=list)  # (t, f, n)

    @property
    def idle_j(self) -> float:
        awake_idle = max(0.0, self.span_s - self.busy_s - self.parked_s)
        return (
            awake_idle * self.idle_power_w
            + self.parked_s * self.sleep_power_w
        )

    @property
    def total_j(self) -> float:
        return self.busy_j + self.idle_j


@dataclass
class RunMetrics:
    requests: List[Request]
    instances: List[InstanceEnergy]
    slo_ttft_s: float
    slo_itl_s: float
    duration_s: float = 0.0
    # fraction of looked-up prompt tokens served by the radix prefix
    # cache; None when no instance ran with a cache
    prefix_hit_rate: Optional[float] = None
    # XLA compiles charged to this run (shared-jit entry points only):
    # 0 for pure-Sim runs and for warmed real-backend clusters — the
    # perf-invariant suite pins the steady-state value at zero
    recompiles: int = 0

    # -- per-phase ----------------------------------------------------------
    def _done(self, tier: Optional[str] = None) -> List[Request]:
        return [
            r for r in self.requests
            if r.finished and (tier is None or r.tier == tier)
        ]

    def admitted(self, tier: Optional[str] = None) -> List[Request]:
        return [
            r for r in self.requests
            if r.admitted and (tier is None or r.tier == tier)
        ]

    def _ttft_slo(self, r: Request) -> float:
        return r.slo_ttft_s if r.slo_ttft_s > 0 else self.slo_ttft_s

    def _itl_slo(self, r: Request) -> float:
        return r.slo_itl_s if r.slo_itl_s > 0 else self.slo_itl_s

    def ttft_values(self, tier: Optional[str] = None) -> np.ndarray:
        return np.array([r.ttft_s for r in self._done(tier)])

    def itl_values(self, tier: Optional[str] = None) -> np.ndarray:
        return np.array(
            [r.itl_mean_s for r in self._done(tier) if r.decode_len > 0]
        )

    def ttft_attainment(self, tier: Optional[str] = None) -> float:
        done = self._done(tier)
        if not done:
            return 0.0
        ok = sum(r.ttft_s <= self._ttft_slo(r) for r in done)
        return ok / len(done)

    def itl_attainment(self, tier: Optional[str] = None) -> float:
        done = [r for r in self._done(tier) if r.decode_len > 0]
        if not done:
            return 1.0
        ok = sum(r.itl_mean_s <= self._itl_slo(r) for r in done)
        return ok / len(done)

    def finished_frac(self) -> float:
        """Finished fraction of *admitted* requests (zero admitted-request
        loss == 1.0; shed requests are accounted via shed_frac)."""
        return len(self._done()) / max(1, len(self.admitted()))

    def shed_frac(self) -> float:
        """Fraction of all arrivals rejected by admission control."""
        n = len(self.requests)
        return (n - len(self.admitted())) / n if n else 0.0

    # -- energy -------------------------------------------------------------
    def energy_j(self) -> float:
        return sum(e.total_j for e in self.instances)

    def energy_by_phase(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.instances:
            key = e.name.split("-")[0]  # "prefill" / "decode"
            out[key] = out.get(key, 0.0) + e.total_j
        return out

    def parked_s_total(self) -> float:
        return sum(e.parked_s for e in self.instances)

    def output_tokens(self, tier: Optional[str] = None) -> int:
        return sum(r.decode_len for r in self._done(tier))

    def epot_j(self) -> float:
        """Energy per output token."""
        t = self.output_tokens()
        return self.energy_j() / t if t else float("inf")

    # first-class efficiency fields (benchmarks read these instead of
    # recomputing energy/token ratios ad hoc)
    def energy_per_token_j(self) -> float:
        """Energy per *emitted* output token (J) — epot under its
        physical name; identical for speculative and plain runs since
        both emit the same final streams."""
        return self.epot_j()

    def tokens_per_joule(self) -> float:
        """Emitted output tokens per Joule — the quantity the paper's
        U-curve sweet spots maximize."""
        e = self.energy_j()
        return self.output_tokens() / e if e > 0 else 0.0

    # -- speculative decoding -----------------------------------------------
    def spec_iterations(self) -> int:
        return sum(r.spec_iters for r in self.requests)

    def spec_drafted(self) -> int:
        return sum(r.spec_drafted for r in self.requests)

    def spec_accepted(self) -> int:
        return sum(r.spec_accepted for r in self.requests)

    def acceptance_rate(self) -> Optional[float]:
        """Accepted fraction of drafted tokens (prefix acceptance);
        None when the run never speculated."""
        d = self.spec_drafted()
        return self.spec_accepted() / d if d else None

    def spec_yield(self) -> Optional[float]:
        """Mean tokens emitted per speculative iteration (accepted
        prefix + bonus); None when the run never speculated."""
        it = self.spec_iterations()
        return (self.spec_accepted() + it) / it if it else None

    def energy_per_accepted_token_j(self) -> Optional[float]:
        """Energy per token emitted through speculative iterations
        (accepted drafts + bonus/correction tokens); None when the run
        never speculated — or decoded partly *outside* speculation
        (e.g. hybrid instances in a spec cluster), where whole-run
        energy over spec-only tokens would overstate the metric.
        Lower than the non-speculative J/token when acceptance
        amortizes the weight/KV streams."""
        it = self.spec_iterations()
        if not it:
            return None
        spec_tokens = self.spec_accepted() + it
        non_spec = sum(
            r.tokens_out - (r.spec_accepted + r.spec_iters)
            for r in self.requests
        )
        if non_spec > 0:
            return None
        return self.energy_j() / spec_tokens

    def preemptions_total(self) -> int:
        return sum(r.preemptions for r in self.requests)

    # -- per-tier -----------------------------------------------------------
    def tiers(self) -> List[str]:
        return sorted({r.tier for r in self.requests})

    def tier_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tier attainment + energy share (energy attributed by
        output-token share — instances are time-shared across tiers)."""
        total_tok = max(1, self.output_tokens())
        out: Dict[str, Dict[str, float]] = {}
        for tier in self.tiers():
            n = sum(r.tier == tier for r in self.requests)
            adm = self.admitted(tier)
            done = self._done(tier)
            tok = self.output_tokens(tier)
            out[tier or "untiered"] = {
                "n": n,
                "admitted": len(adm),
                "shed_frac": round((n - len(adm)) / n, 4) if n else 0.0,
                "finished_frac": round(
                    len(done) / max(1, len(adm)), 4
                ),
                "ttft_attain": round(self.ttft_attainment(tier), 4),
                "itl_attain": round(self.itl_attainment(tier), 4),
                "ttft_p50_ms": round(
                    float(np.median(self.ttft_values(tier)) * 1e3), 2
                ) if done else 0.0,
                "output_tokens": tok,
                "energy_share_j": round(
                    self.energy_j() * tok / total_tok, 1
                ),
                "preemptions": sum(r.preemptions for r in adm),
            }
        return out

    def throughput_tok_s(self) -> float:
        return self.output_tokens() / self.duration_s if self.duration_s else 0.0

    # -- presentation ---------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        extra = {}
        if self.prefix_hit_rate is not None:
            extra["prefix_hit_rate"] = round(self.prefix_hit_rate, 4)
        if self.shed_frac() > 0.0:
            extra["shed_frac"] = round(self.shed_frac(), 4)
        if self.preemptions_total() > 0:
            extra["preemptions"] = self.preemptions_total()
        if self.recompiles > 0:
            extra["recompiles"] = self.recompiles
        if self.acceptance_rate() is not None:
            extra["accept_rate"] = round(self.acceptance_rate(), 4)
            extra["spec_yield"] = round(self.spec_yield(), 4)
            epaj = self.energy_per_accepted_token_j()
            if epaj is not None:  # None: decode partly non-speculative
                extra["energy_per_accepted_tok_mj"] = round(epaj * 1e3, 3)
        return {
            "n_requests": len(self.requests),
            "finished_frac": round(self.finished_frac(), 4),
            "ttft_attain": round(self.ttft_attainment(), 4),
            "itl_attain": round(self.itl_attainment(), 4),
            "ttft_p50_ms": round(float(np.median(self.ttft_values()) * 1e3), 2)
            if len(self._done())
            else 0.0,
            "itl_p50_ms": round(float(np.median(self.itl_values()) * 1e3), 2)
            if len(self.itl_values())
            else 0.0,
            "energy_j": round(self.energy_j(), 1),
            "epot_mj": round(self.epot_j() * 1e3, 3),
            "tok_per_j": round(self.tokens_per_joule(), 3),
            "throughput_tok_s": round(self.throughput_tok_s(), 1),
            "parked_s": round(self.parked_s_total(), 1),
            **extra,
        }

    def cdf(self, metric: str, points: int = 200):
        v = np.sort(
            self.ttft_values() if metric == "ttft" else self.itl_values()
        )
        if v.size == 0:
            return np.zeros(0), np.zeros(0)
        q = np.linspace(0, 1, points)
        return np.quantile(v, q), q
