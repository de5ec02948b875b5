"""Train a ~100M-param LLaMA-style model with the port's training
substrate: WSD schedule, remat, microbatch grad accumulation, async
checkpointing with retention, and restart-from-checkpoint.

    PYTHONPATH=src python examples/train_small_torch.py               # on the card
    PYTHONPATH=src python examples/train_small_torch.py --device cpu  # anywhere
    PYTHONPATH=src python examples/train_small_torch.py --steps 300 --full-size

Kill it mid-run and re-run with the same --ckpt-dir: it resumes.

The twin of ``examples/train_small.py``: the same configs (float32, head
dim 32 for demo-8m and 64 for demo-100m), flags, schedule, two
microbatches, CE chunk, checkpoint retention and zipfian data from
``numpy.random.default_rng(1)``, plus ``--device``.  The weights come
from ``init_params`` with a seeded generator on the device; the CPU
test seeds them from the JAX demo's own instead
(``repro_torch.models.bridge``) and holds the losses against the JAX
demo's.  On the card attention runs the float32 flash kernels
(``flash_prefill.cu`` and ``flash_backward.cu`` at head dim 32).
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training import (
    AdamWConfig,
    CheckpointManager,
    TrainStepConfig,
    init_opt_state,
    make_train_step,
    wsd_schedule,
)
from repro_torch.training._tree import leaves


def model_config(full: bool) -> ModelConfig:
    if full:  # ~100M params
        return ModelConfig(
            name="demo-100m", family="dense", n_layers=10, d_model=640,
            n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560,
            vocab_size=32_000,
            block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
            dtype="float32",
        )
    return ModelConfig(  # ~8M params: seconds-per-step on CPU
        name="demo-8m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=8_192,
        block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
        dtype="float32",
    )


def zipf_batch(rng, batch: int, seq: int, vocab: int, device):
    """Synthetic language-like data: zipfian tokens, next-token labels."""
    base = rng.zipf(1.5, (batch, seq)).clip(1, vocab - 1)
    toks = torch.from_numpy(base.astype(np.int32)).to(device)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -100
    return {"tokens": toks, "labels": labels}


def make_step(cfg: ModelConfig, steps: int, seq: int):
    """The demo's train step: AdamW at 6e-4, two microbatches, CE chunks
    of up to 128, WSD over ``steps``."""
    tcfg = TrainStepConfig(adamw=AdamWConfig(lr=6e-4), microbatches=2,
                           ce_chunk=min(128, seq))
    sched = wsd_schedule(steps // 10 + 1, steps // 2, steps // 2, 6e-4)
    return make_train_step(cfg, tcfg, sched)


def train(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int,
          ckpt_dir: str, device, log=print):
    """Train ``params`` (resuming from ``ckpt_dir``'s latest checkpoint
    if there is one) up to ``steps``; returns (params, opt state, the
    losses of the steps run)."""
    opt = init_opt_state(params)
    step = make_step(cfg, steps, seq)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    restored, start = mgr.restore_latest({"params": params, "opt": opt},
                                         device=device)
    if restored is not None:
        params, opt = restored["params"], restored["opt"]
        log(f"resumed from checkpoint at step {start}")
    else:
        start = 0

    rng = np.random.default_rng(1)
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        params, opt, m = step(params, opt,
                              zipf_batch(rng, batch, seq, cfg.vocab_size,
                                         device))
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0 or i == start:
            log(f"step {i+1:4d}/{steps}  loss {losses[-1]:.4f}"
                f"  lr {float(m['lr']):.2e}  ({time.time()-t0:5.1f}s)")
        if (i + 1) % 25 == 0:
            mgr.save(i + 1, {"params": params, "opt": opt})
    mgr.save(steps, {"params": params, "opt": opt}, block=True)
    log(f"done; checkpoints retained: {mgr.steps()}")
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_small_torch"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config(args.full_size)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    n = sum(t.numel() for t in leaves(params))
    print(f"{cfg.name}: {n/1e6:.1f}M params")
    train(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, device=dev)


if __name__ == "__main__":
    main()
