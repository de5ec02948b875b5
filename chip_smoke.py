#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card identity (``nvidia-smi`` name and power limit);
2. build of the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with CUDA-event times, the roofline bound and one
   library call as a yardstick;
4. serving: llama-3.1-8b at full width and depth in bf16 (random weights
   from a seeded generator) through the port's P/D cluster, with both
   kernels' launch counters read around the run;
5. replay of the first served stream through the port's plain-attention
   path, each emitted token within ``REPLAY_MARGIN`` of the max logit.

It prints the ``kernels`` JSON line and, last, the device line.  TTFT,
ITL and energy come from the control plane's virtual clock (an A100
hardware model), not from the card.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity), used
# for the roofline bound of each kernel.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_kernels.py:18
# Near-argmax replay margin for the bf16 model.  The served path and the
# replay round bf16 activations at different points: attention output
# (kernel vs plain), and every projection, since served decode runs its
# GEMMs at batch 8 and the replay at batch 1.  Each rounding is about
# 2**-9 relative; over 32 layers the float32 logits (spread about 1.3
# with these random weights) drift by a few hundredths, and the largest
# drift over 128256 logits is a few times that (0.16 seen on an H100).
# A wrong kernel leaves the emitted token a typical logit, several units
# below the max.  0.5 sits between the two.
REPLAY_MARGIN = 0.5
MAX_LEN = 1024
SLOTS = 8
L2_BYTES = 50e6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed no card")
    return out


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, args_sets, iters: int = 20) -> float:
    """Mean milliseconds per call with CUDA events, rotating over copies
    of the inputs so that repeated calls do not find them in L2."""
    for a in args_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_sets[i % len(args_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(torch, tensors, call_bytes: float):
    """Enough copies of ``tensors`` that one round exceeds 2x the L2."""
    n = max(1, min(32, math.ceil(2 * L2_BYTES / max(call_bytes, 1.0))))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def max_err(torch, got, want, dtype: str):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = TOL[dtype]
    ok = bool((err <= tol + tol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_case(torch, F, B, S, Hq, Hkv, Dh, dtype, kv_frac, window, softcap,
               timed: bool):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S * 131 + Dh)
    q = torch.randn((B, S, Hq, Dh), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device="cuda").to(dt)
    kv_len = None
    if kv_frac is not None:
        kv_len = torch.full((B,), max(1, int(S * kv_frac)),
                            dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=window, softcap=softcap)
    got = fops.flash_attention(q, k, v, kv_len=kv_len, **kw)
    want = attention_ref(q, k, v, kv_len=kv_len, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, dtype)
    check(ok, f"flash_prefill disagrees with its plain version at S={S} "
              f"{dtype} kv_len={kv_frac} window={window} softcap={softcap}: "
              f"max abs err {err}")
    row = {"shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} Dh={Dh}", "dtype": dtype,
           "kv_len": None if kv_len is None else int(kv_len[0]),
           "window": window, "softcap": softcap, "max_abs_err": err}
    if not timed:
        return row
    # work this data needs: (q, key) pairs that are unmasked
    L = S if kv_len is None else int(kv_len[0])
    qpos = torch.arange(S)
    n_keys = torch.clamp(torch.minimum(qpos + 1, torch.tensor(L)), min=0)
    if window is not None:
        n_keys = torch.minimum(n_keys, torch.tensor(window))
    pairs = int(n_keys.sum()) * B * Hq
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * B * L * Hkv * Dh) * esz
    flops = 4.0 * pairs * Dh
    sets = copies(torch, (q, k, v), (q.numel() + 2 * k.numel()) * esz)
    ms = cuda_ms(torch, lambda a, b, c: fops.flash_attention(
        a, b, c, kv_len=kv_len, **kw), sets)
    plain_ms = cuda_ms(torch, lambda a, b, c: attention_ref(
        a, b, c, kv_len=kv_len, **kw), sets)
    # library yardstick (never called by the port): SDPA on the same
    # inputs (head-major views) with the same mask
    i = torch.arange(S, device="cuda")
    mask = ((i[:, None] >= i[None, :]) & (i[None, :] < L))[None, None]
    lib_ms = cuda_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
        a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
        attn_mask=mask, enable_gqa=True), sets)
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    return row


def decode_case(torch, F, B, C, Hq, Hkv, Dh, dtype, window, softcap,
                timed: bool):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(C * 7 + Dh)
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dt)
    kc = torch.randn((B, C, Hkv, Dh), generator=g, device="cuda").to(dt)
    vc = torch.randn((B, C, Hkv, Dh), generator=g, device="cuda").to(dt)
    # partly filled rows, the last row all empty (a free decode slot)
    filled = torch.randint(C // 4, C, (B,), generator=g, device="cuda")
    filled[-1] = 0
    slots = torch.arange(C, device="cuda")
    slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                           -1).to(torch.int32)
    q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
    kw = dict(window=window, softcap=softcap)
    got = dops.decode_attention(q, kc, vc, slot_pos, q_pos, **kw)
    want = decode_attention_ref(q, kc, vc, slot_pos, q_pos, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, dtype)
    check(ok, f"ring_decode disagrees with its plain version at B={B} C={C} "
              f"{dtype} window={window} softcap={softcap}: max abs err {err}")
    empty_mean = vc[-1].float().mean(dim=0)  # (Hkv, Dh)
    G = Hq // Hkv
    want_empty = empty_mean.repeat_interleave(G, dim=0).to(dt).float()
    empty_err = float((got[-1].float() - want_empty).abs().max())
    check(empty_err <= TOL[dtype] * (1 + float(want_empty.abs().max())),
          f"ring_decode all-empty row is not the mean of V: {empty_err}")
    row = {"shape": f"B={B} C={C} Hq={Hq} Hkv={Hkv} Dh={Dh}", "dtype": dtype,
           "window": window, "softcap": softcap, "max_abs_err": err,
           "empty_row_err": empty_err}
    if not timed:
        return row
    # bytes this data needs: valid slots' K and V, all of V for the empty
    # row (its mean), slot positions, q and out
    valid = int(filled[:-1].sum())
    esz = q.element_size()
    nbytes = (2 * q.numel() + (2 * valid + C) * Hkv * Dh) * esz \
        + slot_pos.numel() * 4 + q_pos.numel() * 4
    flops = 4.0 * valid * Hq * Dh
    sets = copies(torch, (q, kc, vc), (q.numel() + 2 * kc.numel()) * esz)
    ms = cuda_ms(torch, lambda a, b, c: dops.decode_attention(
        a, b, c, slot_pos, q_pos, **kw), sets)
    plain_ms = cuda_ms(torch, lambda a, b, c: decode_attention_ref(
        a, b, c, slot_pos, q_pos, **kw), sets)
    mask = ((slot_pos >= 0) & (slot_pos <= q_pos[:, None]))[:, None, None]
    lib_ms = cuda_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
        a[:, :, None], b.transpose(1, 2), c.transpose(1, 2),
        attn_mask=mask, enable_gqa=True), sets)
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    return row


def kernel_phase(torch, F):
    """Every kernel at the main path's shapes, both dtypes; returns the
    rows and the headline row per kernel (bf16 at the largest shape)."""
    llama = dict(Hq=32, Hkv=8, Dh=128)
    flash_rows = []
    for dtype in ("bfloat16", "float32"):
        for S in (16, 96, 512):
            for kv_frac in (None, 2 / 3):
                flash_rows.append(flash_case(
                    torch, F, 1, S, dtype=dtype, kv_frac=kv_frac,
                    window=None, softcap=None,
                    timed=(S == 512 and dtype == "bfloat16"
                           and kv_frac is not None), **llama))
        for window, softcap in ((64, None), (None, 30.0), (64, 50.0)):
            flash_rows.append(flash_case(
                torch, F, 2, 200, 8, 2, 64, dtype=dtype, kv_frac=0.8,
                window=window, softcap=softcap, timed=False))
    decode_rows = []
    for dtype in ("bfloat16", "float32"):
        decode_rows.append(decode_case(
            torch, F, SLOTS, MAX_LEN, dtype=dtype, window=None, softcap=None,
            timed=(dtype == "bfloat16"), **llama))
        decode_rows.append(decode_case(
            torch, F, 3, 256, 8, 2, 64, dtype=dtype, window=48, softcap=30.0,
            timed=False))
    for r in flash_rows + decode_rows:
        print("  " + json.dumps(r))
    head = {
        "flash_prefill": next(r for r in flash_rows if "ms" in r),
        "ring_decode": next(r for r in decode_rows if "ms" in r),
    }
    errs = {
        "flash_prefill": max(r["max_abs_err"] for r in flash_rows),
        "ring_decode": max(r["max_abs_err"] for r in decode_rows),
    }
    return head, errs


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


def serve_phase(torch):
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import model as M
    from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_real_backend_factory
    from repro_torch.serving.workload import (
        DatasetDist, LengthDist, attach_tokens,
    )

    cfg = REGISTRY["llama-3.1-8b"]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {n_params:,} params, init "
          f"{time.perf_counter() - t0:.1f} s")
    pred = build_predictor(cfg, A100, A100.freq_levels_2, kv_cap=400_000)
    ds = DatasetDist(
        "smoke",
        prefill=LengthDist(200.0, 150.0, lo=64, hi=512),
        decode=LengthDist(32.0, 16.0, lo=16, hi=64),
    )
    reqs = attach_tokens(poisson_workload(ds, 16.0, 1.0, seed=0)[:8],
                         cfg.vocab_size, seed=1)
    check(len(reqs) >= 4, f"workload too small: {len(reqs)} requests")

    walls = {"prefill": [], "decode": []}
    base = make_real_backend_factory(cfg, params, slots=SLOTS,
                                     max_len=MAX_LEN, device="cuda")

    def timed(fn, out):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
            return res
        return run

    def factory(kind, idx, hw, seed, tp=None):
        be = base(kind, idx, hw, seed, tp=tp)
        be._real_prefill = timed(be._real_prefill, walls["prefill"])
        be._real_decode_step = timed(be._real_decode_step, walls["decode"])
        return be

    ccfg = ClusterConfig(
        model=cfg, chip=A100, n_prefill=1, n_decode=1, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=SLOTS, seed=0, backend_factory=factory,
    )
    cluster = PDCluster(ccfg)
    torch.cuda.reset_peak_memory_stats()
    fops.launches = 0
    dops.launches = 0
    t0 = time.perf_counter()
    m = cluster.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"flash_prefill": fops.launches, "ring_decode": dops.launches}
    peak = torch.cuda.max_memory_allocated()

    check(m.finished_frac() == 1.0, f"finished {m.finished_frac()}")
    for r in reqs:
        check(len(r.output_tokens) == r.decode_len + 1,
              f"request {r.rid}: {len(r.output_tokens)} tokens, expected "
              f"{r.decode_len + 1}")
        check(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"request {r.rid}: token id out of range")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    n_dec = sum(r.decode_len for r in reqs)
    dec_s = sum(walls["decode"]) / 1e3
    s = m.summary()
    print(f"served {len(reqs)} requests (prompts "
          f"{min(r.prompt_len for r in reqs)}-{max(r.prompt_len for r in reqs)}"
          f", decode {min(r.decode_len for r in reqs)}-"
          f"{max(r.decode_len for r in reqs)}) in {wall_s:.2f} s wall")
    print("serve: " + json.dumps({
        "requests": len(reqs),
        "prefill_iters": len(walls["prefill"]),
        "prefill_ms_mean": statistics.fmean(walls["prefill"]),
        "prefill_ms_median": statistics.median(walls["prefill"]),
        "decode_iters": len(walls["decode"]),
        "decode_ms_mean": statistics.fmean(walls["decode"]),
        "decode_ms_median": statistics.median(walls["decode"]),
        "decode_tokens": n_dec,
        "decode_tok_s": n_dec / dec_s if dec_s else None,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
    }))
    print("virtual-clock A100 model (not measured on this card): "
          f"ttft_p50_ms={s['ttft_p50_ms']} itl_p50_ms={s['itl_p50_ms']} "
          f"energy_j={s['energy_j']} epot_mj={s['epot_mj']}")
    return cfg, params, reqs, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 5: replay through the plain-attention path
# ---------------------------------------------------------------------------


def replay_phase(torch, cfg, params, r):
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import _bucket

    toks = torch.tensor(r.prompt_tokens, dtype=torch.int32, device="cuda")
    pad = _bucket(len(toks), hi=MAX_LEN)
    buf = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    buf[0, : len(toks)] = toks
    lengths = torch.tensor([len(toks)], dtype=torch.int32, device="cuda")
    logits, cache = M.prefill(params, cfg, buf, lengths, max_len=MAX_LEN,
                              plain_attention=True)
    pos = lengths.clone()
    worst = 0.0
    for i, tok in enumerate(r.output_tokens):
        row = logits[0].double()
        gap = float(row.max() - row[tok])
        worst = max(worst, gap)
        check(gap <= REPLAY_MARGIN,
              f"rid {r.rid} token {i}: emitted id {tok} is {gap:.4f} below "
              f"the plain path's max logit (margin {REPLAY_MARGIN})")
        logits, cache = M.decode_step(
            params, cfg, torch.tensor([tok], dtype=torch.int32,
                                      device="cuda"),
            cache, pos, plain_attention=True)
        pos = pos + 1
    print(f"replay rid {r.rid}: {len(r.output_tokens)} tokens, worst gap to "
          f"the plain path's max logit {worst:.5f} (margin {REPLAY_MARGIN})")


# ---------------------------------------------------------------------------


KERNELS = {
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention/kernel.py:93"),
    "ring_decode": ("src/repro_torch/kernels/csrc/ring_decode.cu",
                    "src/repro/kernels/decode_attention/kernel.py:303"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    # plain float32 references run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_identity()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; tf32 off for matmul and cudnn")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{len(built)} sources (parallel nvcc)")
    for name, (secs, log) in built.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                              log)]
        print(f"  {name}: {secs:.1f} s, {len(regs)} instantiations, "
              f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"spill stores up to {max(spills, default=0)} B (ptxas -v)")

    head, errs = kernel_phase(torch, F)
    cfg, params, reqs, launches = serve_phase(torch)
    replay_phase(torch, cfg, params, reqs[0])

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        h = head[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
