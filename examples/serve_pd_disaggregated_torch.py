"""End-to-end driver of the PyTorch/CUDA port: real tokens through the
full P/D disaggregated stack — continuous batching, KV migration, EcoFreq
per-iteration frequency control, EcoRoute state-space routing, a decode
instance failure with automatic re-prefill, and elastic scale-out.

On the card (the default) it serves llama-3.1-8b at full width in bf16
with random weights from a seeded generator; prefill and decode
attention run in the port's hand-written Hopper kernels.  ``--device
cpu`` serves the reduced float32 model through the kernels' plain
versions.  Latency and energy come from the control plane's virtual
clock (an A100 hardware model), not from the machine running the tokens.

    PYTHONPATH=src python examples/serve_pd_disaggregated_torch.py
    PYTHONPATH=src python examples/serve_pd_disaggregated_torch.py --device cpu
    PYTHONPATH=src python examples/serve_pd_disaggregated_torch.py --profile

``--profile`` (card only) traces the run with ``torch.profiler`` and
prints device time by kernel and the device's busy share of the run.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.power import A100
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import model as M
from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
from repro_torch.serving.cluster import build_predictor
from repro_torch.serving.realengine import make_real_backend_factory
from repro_torch.serving.workload import DatasetDist, LengthDist, attach_tokens


def _profile_report(prof, wall_s: float) -> None:
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_us = sum(e.device_time_total for e in rows)
    print(f"\ndevice busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms "
          f"wall ({busy_us / 1e4 / wall_s:.1f}% busy)")
    print(f"{'device ms':>10} {'calls':>7}  kernel")
    for e in rows[:15]:
        print(f"{e.device_time_total / 1e3:10.2f} {e.count:7d}  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if args.profile and args.device != "cuda":
        ap.error("--profile traces the card")

    base = REGISTRY["llama-3.1-8b"]
    if args.device == "cpu":
        cfg = dataclasses.replace(base.reduced(), dtype="float32")
        max_len, prompts, decodes = 256, LengthDist(24.0, 10.0, hi=100), \
            LengthDist(10.0, 5.0, hi=20)
    else:
        cfg = base
        max_len, prompts, decodes = 1024, LengthDist(200.0, 150.0, hi=512), \
            LengthDist(32.0, 16.0, lo=16, hi=64)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = M.init_params(cfg, gen, device=args.device)
    n = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {n:,} params on {args.device}")

    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000)
    reqs = attach_tokens(
        poisson_workload(DatasetDist("demo", prompts, decodes), 2.5, 16.0,
                         seed=1),
        cfg.vocab_size, seed=2,
    )
    ccfg = ClusterConfig(
        model=base, chip=A100, n_prefill=1, n_decode=2,
        policy="voltana", predictor=pred, kv_capacity_tokens=400_000,
        online_adapt=False, decode_max_running=8, seed=0,
        backend_factory=make_real_backend_factory(
            cfg, params, slots=8, max_len=max_len, device=args.device
        ),
    )
    cluster = PDCluster(ccfg)
    cluster.schedule_failure(8.0, "decode", 0)  # chaos: kill an instance
    cluster.schedule_scale_out(8.5, "decode")  # elastic replacement
    fops.launches = dops.launches = 0
    t0 = time.perf_counter()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m = cluster.run(reqs)
            torch.cuda.synchronize()
    else:
        m = cluster.run(reqs)
    wall_s = time.perf_counter() - t0

    s = m.summary()
    restarted = sum(1 for r in reqs if r.restarts)
    print(f"\nserved {len(reqs)} requests in {wall_s:.2f} s wall, finished "
          f"{s['finished_frac']:.0%}; kernel launches: flash_prefill "
          f"{fops.launches}, ring_decode {dops.launches}")
    print("virtual-clock A100 model: TTFT attain "
          f"{s['ttft_attain']:.2f}, ITL attain {s['itl_attain']:.2f}, "
          f"energy {s['energy_j']:.0f} J ({s['epot_mj']:.1f} mJ/token)")
    print(f"decode instance 0 failed at t=8 s -> {restarted} requests "
          f"re-prefilled; fleet scaled to {len(cluster.decode)} decode "
          "instances")
    for r in [r for r in reqs if r.finished][:3]:
        print(f"req {r.rid}: prompt[{r.prompt_len}] -> "
              f"tokens {r.output_tokens[:8]}...")
    if args.profile:
        _profile_report(prof, wall_s)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
