#!/usr/bin/env python3
"""Does gloo's point-to-point ``send``/``recv`` take CUDA tensors?

The port's P→D handoff (``src/repro_torch/distributed/handoff.py``)
stages device leaves through pinned host buffers under gloo.  This probe
asks the question that design rests on, on two ranks sharing one card:
rank 0 sends a CUDA tensor to rank 1, which receives into a CUDA tensor.
Each attempt runs in a world of its own, in child processes with a time
limit, since a transport handed a device pointer may kill its process.
It then times the staged path the port takes for one dense llama-3.1-8b
handoff (134,348,800 B: the bf16 K/V and int32 positions of a
1,024-slot ring), ``--repeats`` times.

    python3 tools/gloo_cuda_probe.py [--repeats 5]

Prints one JSON line: the direct attempt's outcome, and the staged
path's wall ms by stage on each rank.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time
from pathlib import Path

# llama-3.1-8b's B=1 ring: 32 x 2 x 1,024 x 8 x 128 x 2 B + 32 x 1,024 x 4 B
RING_BYTES = 134_348_800


def _direct(rank, init, out):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    torch.cuda.set_device(0)
    t = torch.arange(1024, dtype=torch.float32, device="cuda")
    if rank == 0:
        dist.send(t, 1)
        res = "sent"
    else:
        got = torch.zeros_like(t)
        dist.recv(got, 0)
        res = "equal" if torch.equal(got, t) else "different data"
    Path(out).write_text(res)
    dist.destroy_process_group()


def _staged(rank, init, out, repeats):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    torch.cuda.set_device(0)
    n = RING_BYTES // 2
    dev = torch.full((n,), rank, dtype=torch.bfloat16, device="cuda")
    times = {"d2h_ms": [], "send_ms": [], "recv_ms": [], "h2d_ms": []}
    for _ in range(repeats):
        dist.barrier()
        if rank == 0:
            t0 = time.perf_counter()
            host = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
            host.copy_(dev)
            t1 = time.perf_counter()
            dist.send(host, 1)
            t2 = time.perf_counter()
            times["d2h_ms"].append((t1 - t0) * 1e3)
            times["send_ms"].append((t2 - t1) * 1e3)
        else:
            t0 = time.perf_counter()
            host = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
            dist.recv(host, 0)
            t1 = time.perf_counter()
            dev.copy_(host)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times["recv_ms"].append((t1 - t0) * 1e3)
            times["h2d_ms"].append((t2 - t1) * 1e3)
    ok = rank == 0 or bool((dev == 0).all())
    Path(out).write_text(json.dumps({"ok": ok, **{
        k: v for k, v in times.items() if v}}))
    dist.destroy_process_group()


def _world(target, *args, timeout=120.0):
    """Run ``target(rank, init, out, *args)`` on two spawned ranks; each
    rank's result, or what became of its process."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"r{r}") for r in range(2)]
        procs = [ctx.Process(target=target, args=(
            r, f"file://{tmp}/store", outs[r], *args)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        res = []
        for p, o in zip(procs, outs):
            if p.is_alive():
                p.kill()
                p.join(10)
                res.append("hung")
            elif Path(o).exists():
                res.append(Path(o).read_text())
            else:
                res.append(f"died, exit code {p.exitcode}")
        return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    direct = _world(_direct, timeout=60.0)
    staged = [json.loads(r) if r.startswith("{") else r
              for r in _world(_staged, args.repeats)]
    print(json.dumps({"gloo_send_cuda_tensor": direct,
                      "staged_ring_bytes": RING_BYTES,
                      "staged_by_rank": staged}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
