"""Training entry point: trains a (reduced or full) config on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck

Counterpart of ``repro/launch/train.py``, with its flags and its output,
plus ``--device`` (the card unless ``--device cpu``).  It runs the WSD
schedule, remat, microbatching, checkpoint/restart (auto-resume from the
latest step), the preemption hook, and ``--compress-grads``, which is
the reference's no-op (the wire format lives in
:mod:`repro_torch.training.compress`).  The synthetic batches come from
``numpy.random.default_rng(seed)`` exactly as in the reference, so both
packages train on the same tokens; the weights come from ``init_params``
with a seeded ``torch.Generator``.  On the card every attention layer
runs the flash kernels forward and backward.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training import (
    AdamWConfig,
    CheckpointManager,
    TrainStepConfig,
    init_error_state,
    init_opt_state,
    make_train_step,
    wsd_schedule,
)


def synthetic_batch(rng, vocab, batch, seq, device=None):
    toks = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = REGISTRY[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainStepConfig(
        adamw=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        ce_chunk=min(512, args.seq),
    )
    sched = wsd_schedule(
        warmup=max(args.steps // 10, 1),
        stable=args.steps // 2,
        decay=args.steps - args.steps // 2,
        peak_lr=args.lr,
    )
    step_fn = make_train_step(cfg, tcfg, sched)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    opt = init_opt_state(params)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        mgr.install_preemption_hook()
        restored, st = mgr.restore_latest({"params": params, "opt": opt},
                                          device=dev)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = st
            print(f"resumed from step {st}")

    err = init_error_state(params) if args.compress_grads else None
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = synthetic_batch(rng, cfg.vocab_size, args.batch, args.seq,
                                dev)
        params, opt, metrics = step_fn(params, opt, batch)
        if args.compress_grads and err is not None:
            pass  # compression is applied inside the DP boundary; see
            # repro_torch.training.compress for the wire-format utilities.
        if (i + 1) % 10 == 0 or i == start:
            print(
                f"step {i+1}/{args.steps} loss={float(metrics['loss']):.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({(time.time()-t0):.1f}s)"
            )
        if mgr and ((i + 1) % args.ckpt_every == 0 or mgr.preempted):
            mgr.save(i + 1, {"params": params, "opt": opt},
                     meta={"loss": float(metrics["loss"])})
            if mgr.preempted:
                print("preemption signal received; checkpointed and exiting")
                mgr.wait()
                return
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt}, block=True)
    print("done")


if __name__ == "__main__":
    main()
