"""Scenario registry: named, golden-pinned workload/cluster setups.

Every benchmark figure so far invented its own trace + config inline,
so "run X against a flash crowd" meant copy-pasting generator calls.
This registry names the canonical scenarios once — production arrival
*shapes* (diurnal, flash crowd, multi-tenant tier mix, agentic
multi-turn, P/D-ratio oscillation, BurstGPT replay) bound to the
cluster features they stress — and pins each one's headline metrics at
smoke scale, so the whole matrix runs as a conformance suite
(``tests/test_scenarios.py``) and as a CI benchmark row
(``benchmarks/fig_traces_replay.py``).

Pin semantics: captured at **smoke scale, seed 0** on the reference
model/chip (llama-3.1-8b on A100, 2P2D).  ``finished_frac`` is exact —
admitted-request loss is a bug, not drift; the rest carry tolerances
wide enough for cross-platform float noise and tight enough that a
scheduling/energy regression trips them.  To (re)pin after an
intentional behavior change::

    PYTHONPATH=src python -m repro_torch.serving.scenarios   # prints fresh pins

then update ``pins=`` below and the ``trace_replay`` section of
``benchmarks/BENCH_baseline.json`` (``tools/bench_gate.py --rebaseline``).

Adding a scenario: write a ``build(seed, smoke) -> Trace`` function
(compose :mod:`repro_torch.serving.traces` segments or ingest a trace), pick
the ``cluster_kw`` the shape stresses, run the module to capture pins,
and add a row to the README scenario table.  ``sweep_rates`` opts the
scenario into the open-loop QPS sweep (knee detection).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.power import A100
from repro_torch.serving.cluster import ClusterConfig, PDCluster
from repro_torch.serving.metrics import RunMetrics
from repro_torch.serving.request import DEFAULT_TIERS, Request
from repro_torch.serving.traces import (
    AgenticSegment,
    BURSTGPT_SAMPLE_CSV,
    DiurnalSegment,
    FlashCrowdSegment,
    TieredSegment,
    Trace,
    load_burstgpt_trace,
    rescale_to_rps,
    synthetic_trace,
    tile,
    trace_from_requests,
)
from repro_torch.serving.workload import (
    AZURE_CODE,
    LMSYS,
    SHAREGPT,
    azure_like,
    synthetic_pd_ratio,
)

MODEL_NAME = "llama-3.1-8b"


@dataclass(frozen=True)
class Scenario:
    """One named workload shape + the cluster features it exercises."""

    name: str
    description: str
    build: Callable[[int, bool], Trace]  # (seed, smoke) -> Trace
    cluster_kw: Dict[str, object] = field(default_factory=dict)
    tokens: bool = False  # replay with deterministic prompt token ids
    sweep_rates: Optional[Tuple[float, ...]] = None  # open-loop QPS sweep
    # metric -> (golden, abs_tol); captured at smoke scale, seed 0
    pins: Dict[str, Tuple[float, float]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _diurnal(seed: int, smoke: bool) -> Trace:
    dur = 180.0 if smoke else 600.0
    reqs = azure_like(2.0 if smoke else 4.0, dur, seed=seed,
                      day_s=dur, t0_frac=0.0)
    return trace_from_requests("diurnal-azure", reqs)


def _flash_crowd(seed: int, smoke: bool) -> Trace:
    dur = 120.0 if smoke else 480.0
    return synthetic_trace(
        [FlashCrowdSegment(
            duration_s=dur, base_rps=2.5 if smoke else 4.0,
            spike_x=6.0, spike_start_s=dur / 3.0, spike_len_s=dur / 8.0,
            dataset=SHAREGPT, spike_dataset=LMSYS,
        )],
        seed=seed, name="flash-crowd",
    )


def _tier_mix(seed: int, smoke: bool) -> Trace:
    dur = 150.0 if smoke else 480.0
    return synthetic_trace(
        [TieredSegment(
            duration_s=dur, rps=4.0 if smoke else 6.0,
            mix=(("interactive", 0.45, LMSYS),
                 ("standard", 0.35, SHAREGPT),
                 ("batch", 0.20, AZURE_CODE)),
        )],
        seed=seed, name="multi-tenant-tiers",
    )


def _agentic(seed: int, smoke: bool) -> Trace:
    return synthetic_trace(
        [AgenticSegment(
            duration_s=60.0 if smoke else 240.0,
            n_conversations=24 if smoke else 96,
            turns_mean=4.0, think_mean_s=3.0,
        )],
        seed=seed, name="agentic-multiturn",
    )


def _pd_oscillation(seed: int, smoke: bool) -> Trace:
    reqs = synthetic_pd_ratio(
        3.0 if smoke else 5.0, 180.0 if smoke else 600.0,
        period_s=45.0, seed=seed,
    )
    return trace_from_requests("pd-oscillation", reqs)


def _burstgpt(seed: int, smoke: bool) -> Trace:
    """Ingest the embedded BurstGPT-format excerpt, rescale its clock
    to a serving-scale rate, and tile cycles back-to-back — end-to-end
    through the foreign-schema loader (``seed`` only varies replayed
    token ids, not the trace shape: replay is deterministic)."""
    del seed
    t = load_burstgpt_trace(BURSTGPT_SAMPLE_CSV, name="burstgpt-replay")
    t = rescale_to_rps(t, 6.0)
    return tile(t, 8 if smoke else 32)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_LONG_PROMPT_SLO = {"slo_ttft_s": 1.0}  # azure/code prompts: >0.6 s prefill

SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            "diurnal-azure",
            "Fig. 2 diurnal two-class Azure mix (conversation flat, "
            "code peaking): trough->peak->trough over one day cycle",
            _diurnal,
            cluster_kw=dict(_LONG_PROMPT_SLO),
            pins={
                "finished_frac": (1.0, 0.0),
                "ttft_attain": (0.9929, 0.02),
                "itl_attain": (1.0, 0.01),
                "energy_per_token_mj": (1047.487, 21.0),
                "output_tokens": (70_734, 0.0),
            },
        ),
        Scenario(
            "flash-crowd",
            "steady ShareGPT base with a 6x LMSYS flash crowd one third "
            "in: burst absorption without attainment collapse",
            _flash_crowd,
            sweep_rates=(3.0, 6.0, 9.0, 12.0, 15.0, 18.0),
            pins={
                "finished_frac": (1.0, 0.0),
                "ttft_attain": (1.0, 0.01),
                "itl_attain": (1.0, 0.01),
                "energy_per_token_mj": (451.204, 9.0),
                "output_tokens": (93_081, 0.0),
            },
        ),
        Scenario(
            "multi-tenant-tiers",
            "interactive/standard/batch tier mix on one Poisson clock: "
            "strict-priority + EDF + admission control under tiers",
            _tier_mix,
            cluster_kw={"slo_tiers": DEFAULT_TIERS},
            pins={
                "finished_frac": (1.0, 0.0),
                "shed_frac": (0.0, 0.0),
                "ttft_attain": (1.0, 0.01),
                "itl_attain": (1.0, 0.01),
                "energy_per_token_mj": (542.911, 11.0),
                "output_tokens": (99_623, 0.0),
            },
        ),
        Scenario(
            "agentic-multiturn",
            "agentic multi-turn conversations (prefix-extending turns, "
            "think-time gaps): radix prefix cache + affinity routing",
            _agentic,
            cluster_kw={"prefix_cache": True},
            tokens=True,
            pins={
                "finished_frac": (1.0, 0.0),
                "ttft_attain": (1.0, 0.01),
                "itl_attain": (1.0, 0.01),
                "energy_per_token_mj": (1378.881, 28.0),
                "prefix_hit_rate": (0.6727, 0.05),
                "output_tokens": (13_534, 0.0),
            },
        ),
        Scenario(
            "pd-oscillation",
            "Appx. N prefill/decode demand-ratio oscillation on a "
            "45 s period: P/D fleet balance under phase swings",
            _pd_oscillation,
            cluster_kw=dict(_LONG_PROMPT_SLO),
            pins={
                "finished_frac": (1.0, 0.0),
                "ttft_attain": (1.0, 0.01),
                "itl_attain": (1.0, 0.01),
                "energy_per_token_mj": (600.275, 12.0),
                "output_tokens": (110_248, 0.0),
            },
        ),
        Scenario(
            "burstgpt-replay",
            "BurstGPT-schema trace ingested, rate-rescaled and tiled: "
            "production burstiness through the foreign-format loader",
            _burstgpt,
            sweep_rates=(4.0, 8.0, 12.0, 16.0, 20.0, 24.0),
            pins={
                "finished_frac": (1.0, 0.0),
                "ttft_attain": (1.0, 0.01),
                "itl_attain": (1.0, 0.01),
                "energy_per_token_mj": (402.647, 8.0),
                "output_tokens": (95_416, 0.0),
            },
        ),
    )
}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def build_cluster_config(
    scenario: Scenario,
    seed: int = 0,
    predictor_bank: Optional[dict] = None,
    **overrides,
) -> ClusterConfig:
    """The reference cluster for the conformance matrix: llama-3.1-8b
    on a 2P2D A100 fleet, offline predictor, no online adaptation —
    deterministic given the seed.  ``overrides`` win over scenario
    ``cluster_kw`` (sweeps shrink the fleet, tests inject backends)."""
    kw: Dict[str, object] = {
        "model": REGISTRY[MODEL_NAME],
        "chip": A100,
        "n_prefill": 2,
        "n_decode": 2,
        "kv_capacity_tokens": 400_000,
        "online_adapt": False,
        "seed": seed,
        "predictor_bank": predictor_bank,
    }
    kw.update(scenario.cluster_kw)
    kw.update(overrides)
    return ClusterConfig(**kw)


def scenario_requests(
    scenario: Scenario, seed: int = 0, smoke: bool = True
) -> List[Request]:
    trace = scenario.build(seed, smoke)
    return trace.to_requests(tokens=scenario.tokens, seed=seed)


def run_scenario(
    name: str,
    seed: int = 0,
    smoke: bool = True,
    predictor_bank: Optional[dict] = None,
    cluster_cls=PDCluster,
    **overrides,
) -> Tuple[RunMetrics, PDCluster, List[Request]]:
    scenario = SCENARIOS[name]
    reqs = scenario_requests(scenario, seed=seed, smoke=smoke)
    cfg = build_cluster_config(
        scenario, seed=seed, predictor_bank=predictor_bank, **overrides
    )
    cluster = cluster_cls(cfg)
    return cluster.run(reqs), cluster, reqs


def scenario_summary(m: RunMetrics) -> Dict[str, float]:
    """The pinnable slice of a run: exact conservation counters plus
    the headline efficiency/attainment metrics."""
    out = {
        "finished_frac": round(m.finished_frac(), 4),
        "shed_frac": round(m.shed_frac(), 4),
        "ttft_attain": round(m.ttft_attainment(), 4),
        "itl_attain": round(m.itl_attainment(), 4),
        "energy_per_token_mj": round(m.energy_per_token_j() * 1e3, 3),
        "output_tokens": m.output_tokens(),
    }
    if m.prefix_hit_rate is not None:
        out["prefix_hit_rate"] = round(m.prefix_hit_rate, 4)
    return out


def check_pins(
    scenario: Scenario, summary: Dict[str, float]
) -> List[str]:
    """Compare a run summary against the scenario's golden pins;
    returns human-readable mismatches (empty == conformant)."""
    bad: List[str] = []
    for metric, (golden, tol) in scenario.pins.items():
        got = summary.get(metric)
        if got is None:
            bad.append(f"{scenario.name}: pinned metric {metric} missing")
        elif abs(float(got) - golden) > tol:
            bad.append(
                f"{scenario.name}: {metric} = {got} drifted from "
                f"golden {golden} (tol ±{tol})"
            )
    return bad


def capture_pins(smoke: bool = True) -> Dict[str, Dict[str, float]]:
    """Run the whole matrix and print fresh pin values (repinning aid;
    ``python -m repro_torch.serving.scenarios``)."""
    bank: dict = {}
    out: Dict[str, Dict[str, float]] = {}
    for name in SCENARIOS:
        m, _, _ = run_scenario(name, smoke=smoke, predictor_bank=bank)
        out[name] = scenario_summary(m)
    return out


if __name__ == "__main__":
    print(json.dumps(capture_pins(), indent=2))
