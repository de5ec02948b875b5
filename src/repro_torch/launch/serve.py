"""Serving driver: run the P/D disaggregated cluster on a workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.1-8b \
        --dataset sharegpt --rps 8 --duration 60 --policy voltana

Workload sources (mutually exclusive):

* ``--dataset NAME`` — Poisson arrivals over a registered length
  distribution (every ``repro_torch.serving.workload.DATASETS`` entry, plus
  the ``azure`` diurnal-mix and ``pd-ratio`` oscillation generators);
* ``--scenario NAME`` — a named scenario from the registry
  (``repro_torch.serving.scenarios.SCENARIOS``), replayed at pin scale;
* ``--trace PATH`` — replay a trace file (canonical / Azure / BurstGPT
  schemas auto-detected); ``--rps`` rescales its arrival rate.

Policies: voltana (EcoFreq+EcoPred+EcoRoute) | ecofreq-only |
static (--static-freq MHz) | powercap (--cap-w W).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.power import CHIPS
from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
from repro_torch.serving.traces import load_trace, rescale_to_rps
from repro_torch.serving.workload import DATASETS, azure_like, synthetic_pd_ratio

# generator-backed pseudo-datasets (not simple length distributions)
GENERATORS = {
    "azure": azure_like,  # alias: the two azure classes on a diurnal mix
    "pd-ratio": synthetic_pd_ratio,
}


def build_workload(args):
    if args.trace is not None:
        trace = load_trace(args.trace)
        if args.rps is not None:
            trace = rescale_to_rps(trace, args.rps)
        return trace.to_requests(seed=args.seed)
    if args.scenario is not None:
        from repro_torch.serving.scenarios import scenario_requests, SCENARIOS
        return scenario_requests(
            SCENARIOS[args.scenario], seed=args.seed, smoke=False
        )
    rps = 8.0 if args.rps is None else args.rps
    if args.dataset in GENERATORS:
        return GENERATORS[args.dataset](
            rps, args.duration, seed=args.seed
        )
    return poisson_workload(
        DATASETS[args.dataset], rps, args.duration, seed=args.seed
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.1-8b")
    ap.add_argument("--chip", default="a100-80g-sxm", choices=sorted(CHIPS))
    ap.add_argument("--dataset", default="sharegpt",
                    choices=sorted([*DATASETS, *GENERATORS]))
    ap.add_argument("--scenario", default=None,
                    help="replay a named registry scenario instead of "
                         "--dataset (see repro_torch.serving.scenarios)")
    ap.add_argument("--trace", default=None,
                    help="replay a trace file (canonical/Azure/BurstGPT "
                         "CSV schema, auto-detected)")
    ap.add_argument("--rps", type=float, default=None,
                    help="offered rate (default 8); with --trace, "
                         "rescales the trace clock to this rate")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--policy", default="voltana",
                    choices=["voltana", "ecofreq-only", "static", "powercap"])
    ap.add_argument("--static-freq", type=float, default=None)
    ap.add_argument("--cap-w", type=float, default=None)
    ap.add_argument("--n-prefill", type=int, default=2)
    ap.add_argument("--n-decode", type=int, default=2)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--slo-ttft-ms", type=float, default=600.0)
    ap.add_argument("--slo-itl-ms", type=float, default=60.0)
    ap.add_argument("--freq-levels", type=int, default=2, choices=[2, 5])
    ap.add_argument("--delta", type=float, default=500.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.scenario is not None and args.trace is not None:
        ap.error("--scenario and --trace are mutually exclusive")

    chip = CHIPS[args.chip]
    model = REGISTRY[args.arch]
    reqs = build_workload(args)
    cfg = ClusterConfig(
        model=model,
        chip=chip,
        n_prefill=args.n_prefill,
        n_decode=args.n_decode,
        tp=args.tp,
        slo_ttft_s=args.slo_ttft_ms / 1e3,
        slo_itl_s=args.slo_itl_ms / 1e3,
        policy=args.policy,
        static_freq=args.static_freq,
        power_cap_w=args.cap_w,
        freq_options=(
            chip.freq_levels_5 if args.freq_levels == 5 else
            chip.freq_levels_2
        ),
        delta=args.delta,
        seed=args.seed,
    )
    metrics = PDCluster(cfg).run(reqs)
    print(json.dumps(metrics.summary(), indent=2))


if __name__ == "__main__":
    main()
