#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, on a machine with a card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card identity (``nvidia-smi`` name and power limit);
2. build of the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (registers, shared memory and spills of the tensor-core kernels from
   ``ptxas -v``), and a check that ``cuobjdump -sass`` of those libraries
   shows what ``REDESIGNED`` requires of each: the tensor-core product
   (HMMA), and the async copy (LDGSTS) where a kernel stages by cp.async;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes, with CUDA-event times, the roofline bound and,
   where one PyTorch call computes the same function, its time as a
   yardstick (``vs_library``, ``bound_frac``).  ``ms``, ``plain_ms`` and
   ``library_ms`` are host-paced (:func:`cuda_ms`); ``device_ms`` and
   ``library_device_ms`` time the device alone and ``host_ms`` the
   wrapper's enqueue (:func:`queued_ms`).  Beside them the LM head's
   bf16 x bf16 -> float32 product at a decode step's shape, against the
   float32 upcast it replaced and its bytes bound (:func:`lm_head_case`);
4. serving: llama-3.1-8b at full width and depth in bf16 (random weights
   from a seeded generator) through the port's P/D cluster over the dense
   ring cache, with the kernels' launch counters read around the run.
   The decode instance replays its steps from CUDA graphs (the default on
   the card); every serve phase checks one capture per step entry it
   used and a replay for every later step, and prints the loop's
   dispatch / device-wait split (``serving.loopprof``) and each graph's
   device time a replay (:func:`step_device_ms`).  The same
   workload is then served with ``cuda_graphs=False`` and must emit the
   same token streams;
5. replay of the first served stream through the port's plain-attention
   path, each emitted token within ``REPLAY_MARGIN`` of the max logit;
6. paged serving of the same weights: a multi-turn workload over the
   paged KV pool with a radix prefix cache (prefix hits prefill with the
   query-offset flash kernel, decode runs the paged kernel at T = 1),
   pools that balance, and a replay of a prefix-hit stream;
7. paged serving with speculative draft–verify (``SPEC_K`` proposals from
   a small seeded drafter, one verify launch at T = SPEC_K + 1), with the
   accepted draft tokens replayed through the plain drafter and the
   verify-emitted ones through the plain target;
8. with the llama weights freed, mamba2-2.7b at full width and depth in
   bf16 through the same dense P/D cluster (the recurrent state handed
   from prefill to decode), ``ssd_scan`` launched once per layer per
   prefill and no attention kernel, one stream replayed through the
   plain ``L.ssd_chunked`` path, and that stream's prefill state, every
   layer, held against the plain path's: on the served weights, and
   with x/B/C rescaled so that the scan dominates the mixer's output;
   served again eagerly, with the same streams, as phase 4;
9. with Mamba2 freed, a world of ``MESH_TP`` = 2 ranks spawned on the one
   card (gloo: NCCL refuses two ranks on one device), every rank holding
   its shards of llama-3.1-8b at full width and depth (the phase 4
   weights, cut as they are drawn).  Each rank holds the three
   head-sharded decode-attention wrappers against their plain versions
   on the full tensors, then serves through a tp=2 P/D cluster (one
   prefill and one decode instance on the same two ranks) dense, paged
   and speculative, as phases 4, 6 and 7; both ranks must emit the same
   streams, no rank captures a graph (mesh slices run eagerly), and the
   parent replays one stream per serve through the meshless plain path;
10. with llama freed, ministral-3b (G = 3) at full width and depth in
   bf16, served as phase 4 (dense ring, step graphs) with a replay, then
   as phase 7 (paged pool, prefix reuse, speculative verify at
   T = SPEC_K + 1 over 9 rows a kv head) with a replay by token kind;
11. qwen3-32b (q/k norm, 64 layers, G = 8, 65.5 GB of weights) served as
   phase 4 with a replay;
12. phi4-mini-3.8b, minicpm-2b (tied odd-width head, head dim 64, MHA)
   and chameleon-34b (68.6 GB): one prefill of a ``FAMILY_PROMPT``-token
   prompt and ``FAMILY_STEPS`` greedy decode steps through the kernel
   path, one flash_prefill and one ring_decode launch a layer a call,
   and the same tokens teacher-forced through the plain path, each
   within ``REPLAY_MARGIN`` of its max logit.  Each of phases 10-12
   frees its weights before the next and prints its peak memory.

It prints the ``kernels`` JSON line and, last, the device line.

    python3 chip_smoke.py --kernels-only [--src OTHER_CHECKOUT/src]

runs phases 1-3 alone (no SASS check), on the port's sources under
``--src`` when given: another checkout's kernels, built in that
checkout, timed by this script's methods in the same process.  TTFT,
ITL and energy come from the control plane's virtual clock (an A100
hardware model), not from the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity), used
# for the roofline bound of each kernel.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_kernels.py:18
# the SSD scan's, scale-normalised by the reference's largest magnitude
# (tests/test_kernels.py:256-262)
SSD_TOL = {"bfloat16": 3e-2, "float32": 1e-5}
# Near-argmax replay margin for the bf16 model.  The served path and the
# replay round bf16 activations at different points: attention output
# (kernel vs plain), and every projection, since served decode runs its
# GEMMs at batch 8 and the replay at batch 1.  Each rounding is about
# 2**-9 relative; over 32 layers the float32 logits (spread about 1.3
# with these random weights) drift by a few hundredths, and the largest
# drift over 128256 logits is a few times that (0.16 seen on an H100).
# A wrong kernel leaves the emitted token a typical logit, several units
# below the max.  0.5 sits between the two.  mamba2-2.7b's replay (phase
# 8) keeps the margin but cannot judge its SSD path: with the seeded
# init the scan's share of y is far below bf16's rounding of y + D*x,
# so the kernel and the state are checked through ``state_phase``.
REPLAY_MARGIN = 0.5
MAX_LEN = 1024
SLOTS = 8
L2_BYTES = 50e6
SLEEP_CYCLES = 100_000_000  # about 50 ms of SM clock: queued_ms's head start
SPEC_K = 2  # draft proposals per verify pass: T = SPEC_K + 1
PAGE_SIZE = 16
PMAX = MAX_LEN // PAGE_SIZE
POOL_PAGES = (2 * SLOTS + 8) * PMAX  # the backend's default pool
MESH_TP = 2  # phase 9: ranks of the world, each instance's slice width
MESH_TIMEOUT_S = 600.0  # the parent's wait for the phase 9 world


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
# What the compiler made of the redesigned kernels
# ---------------------------------------------------------------------------

# the kernels rebuilt on the tensor cores, and what the SASS of each
# library must show: the tensor-core product (HMMA), the async copy
# (LDGSTS), ldmatrix (LDSM)
REDESIGNED = {
    "flash_prefill": ("HMMA", "LDGSTS", "LDSM"),
    "paged_attention": ("HMMA", "LDGSTS", "LDSM"),
    "ring_decode": ("HMMA", "LDGSTS", "LDSM"),
    "ssd_scan": ("HMMA", "LDGSTS", "LDSM"),
}


def _mangled_name(mangled: str) -> str:
    """The last of the ``<length><name>`` parts of ``_ZN...``: the
    kernel's own name after its (anonymous) namespace."""
    names, i = [], mangled.find("_ZN") + 3
    while i > 2 and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j: j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return names[-1] if names else mangled


def ptxas_table(log: str):
    """Per kernel instantiation in ``ptxas -v`` output: registers, static
    shared memory and spill bytes (dynamic shared memory is set at the
    launch, see each source)."""
    rows = {}
    for block in log.split("Compiling entry function ")[1:]:
        mangled = re.match(r"'(\w+)'", block).group(1)
        kernel = _mangled_name(mangled)
        args = re.findall(r"Li(\d+)E", mangled)
        if "IfLi" in mangled:
            args.insert(0, "float")
        label = f"{kernel}<{','.join(args)}>"
        used = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        rows[label] = {
            "registers": int(used.group(1)) if used else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
            "spill_store_bytes": int(spill.group(1)) if spill else None,
            "spill_load_bytes": int(spill.group(2)) if spill else None,
        }
    return rows


def sass_listings(_build):
    """``cuobjdump -sass`` of each redesigned library: {library: text}."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return {name: subprocess.run(
        [tool, "-sass", str(_build.library_path(name))], check=True,
        capture_output=True, text=True, timeout=300).stdout
        for name in REDESIGNED}


def sass_ops(listings):
    """{library: {op: shown}}: whether each redesigned library's SASS
    listing shows each instruction ``REDESIGNED`` requires of it."""
    return {name: {op: op in listings[name] for op in ops}
            for name, ops in REDESIGNED.items()}


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, args_sets, iters: int = 20) -> float:
    """Mean milliseconds per call with CUDA events, rotating over copies
    of the inputs so that repeated calls do not find them in L2.  The
    host paces the launches, so where a call enqueues slower than the
    device runs it, this reads the host."""
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


def queued_ms(torch, fn, args_sets, iters: int = 20):
    """(device ms, host ms) per call, over the same rotation of copies as
    :func:`cuda_ms`.  The launches queue behind a sleeping kernel while
    the host enqueues them, so the events time the device running the
    calls back to back (the sleep grows until the host finishes
    enqueueing inside it), and the host's clock times what one call costs
    the host to enqueue."""
    for a in args_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event(enable_timing=True)
    cycles = SLEEP_CYCLES
    for _ in range(4):
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*args_sets[i % len(args_sets)])
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < slept.elapsed_time(start):
            break
        cycles *= 4
    return start.elapsed_time(end) / iters, host_ms / iters


def device_ms_by_kernel(torch, call, iters: int = 20):
    """Device milliseconds per call of each kernel that ``call()``
    launches, from ``torch.profiler``'s CUDA activity, by the kernel's
    own name (namespaces and template arguments dropped)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0)
        if us:
            name = kernel_name(ev.key)
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its return type,
    namespaces, template arguments and parameters."""
    name = key.replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name.replace("void ", "", 1))[0]
    return name.split("::")[-1].strip()


def copies(torch, tensors, call_bytes: float):
    """Enough copies of ``tensors`` that one round exceeds 2x the L2."""
    n = max(1, min(32, math.ceil(2 * L2_BYTES / max(call_bytes, 1.0))))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


TIMINGS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
           "device_ms", "host_ms", "library_device_ms")


def timings(row):
    """A headline row's times, bound and ratios, for the ``kernels`` line.
    ``ms``, ``plain_ms`` and ``library_ms`` are host-paced
    (:func:`cuda_ms`); ``device_ms`` and ``library_device_ms`` are the
    device's back-to-back time and ``host_ms`` the wrapper's enqueue cost
    per call (:func:`queued_ms`)."""
    return {**{k: row[k] for k in TIMINGS}, **ratios(row)}


def ratios(row):
    """``vs_library`` (ms / library_ms, null without a library call) and
    ``bound_frac`` (bound_ms / ms), from one call's host-paced numbers,
    and the same two from its device times."""
    lib, dlib = row["library_ms"], row.get("library_device_ms")
    return {"vs_library": row["ms"] / lib if lib else None,
            "bound_frac": row["bound_ms"] / row["ms"],
            "device_vs_library": row["device_ms"] / dlib if dlib else None,
            "device_bound_frac": row["bound_ms"] / row["device_ms"]}


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
               timed: bool, q_start=None):
    """One prefill case.  With ``q_start`` (the paged prefill after a
    prefix hit) the keys are the gathered view of a full table
    (``MAX_LEN`` positions), query row i sits at ``q_start + i`` and
    ``kv_len = q_start + S * kv_frac``."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dt = getattr(torch, dtype)
    Skv = S if q_start is None else MAX_LEN
    g = torch.Generator(device="cuda").manual_seed(
        S * 131 + Dh + (0 if q_start is None else q_start + 1))
    q = torch.randn((B, S, Hq, Dh), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Skv, Hkv, Dh), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Skv, Hkv, Dh), generator=g, device="cuda").to(dt)
    qs = 0 if q_start is None else q_start
    kv_len = qst = None
    if kv_frac is not None:
        kv_len = torch.full((B,), qs + max(1, int(S * kv_frac)),
                            dtype=torch.int32, device="cuda")
    if q_start is not None:
        qst = torch.full((B,), q_start, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=kv_len,
              q_start=qst)
    got = fops.flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, dtype)
    check(ok, f"flash_prefill disagrees with its plain version at S={S} "
              f"{dtype} kv_len={kv_frac} window={window} softcap={softcap} "
              f"q_start={q_start}: max abs err {err}")
    row = {"shape": f"B={B} S={S} Skv={Skv} Hq={Hq} Hkv={Hkv} Dh={Dh}",
           "dtype": dtype, "q_start": q_start,
           "kv_len": None if kv_len is None else int(kv_len[0]),
           "window": window, "softcap": softcap, "max_abs_err": err}
    if not timed:
        return row
    # work this data needs: (q, key) pairs that are unmasked
    L = Skv if kv_len is None else int(kv_len[0])
    qpos = qs + torch.arange(S)
    hi = torch.minimum(qpos, torch.tensor(L - 1))
    lo = torch.zeros_like(qpos) if window is None else torch.clamp(
        qpos - window + 1, min=0)
    pairs = int(torch.clamp(hi - lo + 1, min=0).sum()) * B * Hq
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * B * L * Hkv * Dh) * esz
    flops = 4.0 * pairs * Dh
    sets = copies(torch, (q, k, v), (q.numel() + 2 * k.numel()) * esz)
    ms = cuda_ms(torch, lambda a, b, c: fops.flash_attention(a, b, c, **kw),
                 sets)
    plain_ms = cuda_ms(torch, lambda a, b, c: attention_ref(a, b, c, **kw),
                       sets)
    # library yardstick (never called by the port): SDPA on the same
    # inputs (head-major views) with the same mask
    qp = (qs + torch.arange(S, device="cuda"))[:, None]
    j = torch.arange(Skv, device="cuda")[None, :]
    mask = ((qp >= j) & (j < L))[None, None]

    def lib(a, b, c):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    lib_ms = cuda_ms(torch, lib, sets)
    dev_ms, host_ms = queued_ms(
        torch, lambda a, b, c: fops.flash_attention(a, b, c, **kw), sets)
    lib_dev_ms, _ = queued_ms(torch, lib, sets)
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=lib_dev_ms)
    row.update(ratios(row))
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

    def lib(a, b, c):
        return F.scaled_dot_product_attention(
            a[:, :, None], b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    lib_ms = cuda_ms(torch, lib, sets)
    dev_ms, host_ms = queued_ms(torch, lambda a, b, c: dops.decode_attention(
        a, b, c, slot_pos, q_pos, **kw), sets)
    by_kernel = device_ms_by_kernel(torch, lambda: dops.decode_attention(
        q, kc, vc, slot_pos, q_pos, **kw))
    lib_dev_ms, _ = queued_ms(torch, lib, sets)
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=lib_dev_ms, device_ms_by_kernel=by_kernel)
    row.update(ratios(row))
    return row


def ring_empty_case(torch, dtype, C=1000, Hq=32, Hkv=8, Dh=128):
    """Rows with no valid slot, over a ring that is not a whole number of
    the kernel's runs: every slot empty (-1), and every slot holding a
    position after q's, beside a row that has valid slots.  Each empty
    row must come out of the combine as the mean of V over the C slots."""
    from repro_torch.kernels.decode_attention import ops as dops

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(C + Dh)
    q = torch.randn((3, Hq, Dh), generator=g, device="cuda").to(dt)
    kc = torch.randn((3, C, Hkv, Dh), generator=g, device="cuda").to(dt)
    vc = torch.randn((3, C, Hkv, Dh), generator=g, device="cuda").to(dt)
    slots = torch.arange(C, device="cuda")
    slot_pos = torch.stack([torch.where(slots < 300, slots, -1),
                            torch.full_like(slots, -1),
                            slots + 20]).to(torch.int32)
    q_pos = torch.tensor([299, 0, 10], dtype=torch.int32, device="cuda")
    got = dops.decode_attention(q, kc, vc, slot_pos, q_pos)
    torch.cuda.synchronize()
    errs = []
    for row in (1, 2):
        want = vc[row].float().mean(dim=0).repeat_interleave(Hq // Hkv, dim=0)
        errs.append(float((got[row].float() - want).abs().max()))
        check(errs[-1] <= TOL[dtype] * (1 + float(want.abs().max())),
              f"ring_decode: a row with no valid slot (row {row}, C={C}, "
              f"{dtype}) is not the mean of V: {errs[-1]}")
    return {"shape": f"B=3 C={C} Hq={Hq} Hkv={Hkv} Dh={Dh}", "dtype": dtype,
            "empty_rows": "all -1; all after q_pos", "empty_row_errs": errs,
            "max_abs_err": max(errs)}


def paged_case(torch, F, B, T, Hq, Hkv, Dh, lengths, dtype, window, softcap,
               timed: bool, Pmax=PMAX, pool_pages=POOL_PAGES):
    """One paged decode / verify case over a pool of ``pool_pages`` pages
    plus the scratch page, with shuffled disjoint block tables (-1 past
    each row's last page) and ragged lengths.  A ``length == 0`` row must
    return exactly 0 and stays out of the comparison with the plain
    version (which averages V there); T = 1 must equal the decode call
    bit for bit."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import (
        paged_verify_attention_ref,
    )

    ps = PAGE_SIZE
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(T * 977 + Dh + B)
    P = pool_pages + 1
    q = torch.randn((B, T, Hq, Dh), generator=g, device="cuda").to(dt)
    kp = torch.randn((P, ps, Hkv, Dh), generator=g, device="cuda").to(dt)
    vp = torch.randn((P, ps, Hkv, Dh), generator=g, device="cuda").to(dt)
    perm = torch.randperm(P - 1, generator=g, device="cuda").to(torch.int32)
    bt = torch.full((B, Pmax), -1, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lengths):
        pages = -(-n // ps)
        bt[b, :pages] = perm[b * Pmax: b * Pmax + pages]
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(window=window, softcap=softcap)
    got = dops.paged_verify_attention(q, kp, vp, bt, ln, **kw)
    want = paged_verify_attention_ref(q, kp, vp, bt, ln, **kw)
    torch.cuda.synchronize()
    live = [b for b, n in enumerate(lengths) if n > 0]
    err, ok = max_err(torch, got[live], want[live], dtype)
    check(ok, f"paged_attention disagrees with its plain version at B={B} "
              f"T={T} {dtype} window={window} softcap={softcap}: max abs "
              f"err {err}")
    for b, n in enumerate(lengths):
        if n == 0:
            check(bool((got[b] == 0).all()),
                  f"paged_attention: a length-0 row is not 0 (row {b})")
    if T == 1:
        dec = dops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt,
                                          ln, **kw)
        check(torch.equal(dec, got[:, 0]),
              "paged T=1 is not bit-exact with the paged decode call")
    row = {"shape": f"B={B} T={T} Hq={Hq} Hkv={Hkv} Dh={Dh} ps={ps} "
                    f"Pmax={Pmax} pool={P}", "dtype": dtype,
           "lengths": list(lengths), "window": window, "softcap": softcap,
           "max_abs_err": err, "len0_rows_zero": len(live) < B}
    if not timed:
        return row
    # bytes this data needs: each row's valid K/V, q, out, tables and
    # lengths; operations: 4 * Dh per unmasked (q row, key) pair
    esz = q.element_size()
    n_tok = sum(lengths)
    nbytes = (2 * q.numel() + 2 * n_tok * Hkv * Dh) * esz \
        + bt.numel() * 4 + ln.numel() * 4
    pairs = 0
    for n in lengths:
        for t in range(T):
            qpos = n - T + t
            lo = 0 if window is None else max(0, qpos - window + 1)
            pairs += max(0, min(qpos, n - 1) - lo + 1)
    flops = 4.0 * pairs * Hq * Dh
    sets = copies(torch, (q, kp, vp), (q.numel() + 2 * n_tok * Hkv * Dh)
                  * esz)
    ms = cuda_ms(torch, lambda a, b, c: dops.paged_verify_attention(
        a, b, c, bt, ln, **kw), sets)
    by_kernel = device_ms_by_kernel(torch, lambda: dops.paged_verify_attention(
        q, kp, vp, bt, ln, **kw))
    plain_ms = cuda_ms(torch, lambda a, b, c: paged_verify_attention_ref(
        a, b, c, bt, ln, **kw), sets)
    # library yardstick (never called by the port): SDPA over the
    # pre-gathered dense view with the same mask; the gather is not timed
    C = Pmax * ps
    idx = torch.clamp(bt.long(), min=0)
    dense = [(a, b[idx].reshape(B, C, Hkv, Dh), c[idx].reshape(B, C, Hkv,
                                                                Dh))
             for a, b, c in sets]
    pos = torch.arange(C, device="cuda")[None, None]
    qpos = ln[:, None] - T + torch.arange(T, device="cuda")[None]
    mask = ((pos < ln[:, None, None]) & (pos <= qpos[..., None]))[:, None]

    def lib(a, b, c):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    lib_ms = cuda_ms(torch, lib, dense)
    dev_ms, host_ms = queued_ms(
        torch, lambda a, b, c: dops.paged_verify_attention(
            a, b, c, bt, ln, **kw), sets)
    lib_dev_ms, _ = queued_ms(torch, lib, dense)
    del dense
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=lib_dev_ms,
               library_note="SDPA over the pre-gathered "
               "dense view, gather not timed",
               device_ms_by_kernel=by_kernel)
    row.update(ratios(row))
    return row


def model_law(torch, g, B, S, H):
    """dt and A drawn as ``init_params`` makes them: dt = softplus(dt_raw
    + dt_bias) with softplus(dt_bias) log-uniform in [1e-3, 0.1], and -A
    uniform in [1, 16], so the state remembers up to about 1000 tokens."""
    u = torch.rand((H,), generator=g, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt_raw = 0.1 * torch.randn((B, S, H), generator=g, device="cuda")
    A = -(1.0 + 15.0 * torch.rand((H,), generator=g, device="cuda"))
    return torch.nn.functional.softplus(dt_raw + dt_bias), A


def ssd_case(torch, B, S, H, P, N, chunk, dtype, timed: bool, length=None,
             fused=False, law=False):
    """One SSD scan case.  ``length``: x = dt = 0 past it (the model's
    pad tail), so the final state must be the one after ``length``
    tokens.  ``fused``: x, B and C are slices of one (B, S, conv_dim)
    tensor, as the model passes them (only such a case is timed).
    ``law``: dt and A under the model's law (``model_law``), whose long
    memory carries across every sub-chunk and chunk; otherwise dt is
    about 0.7 and A about -1, a memory of about 2 tokens."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_ref

    check(fused or not timed, "ssd_case times the model's layout only")
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S * 31 + H + N)
    di = H * P

    def split(xbc):
        return (xbc[..., :di].reshape(B, S, H, P), xbc[..., di: di + N],
                xbc[..., di + N:])

    if fused:
        xbc = torch.randn((B, S, di + 2 * N), generator=g, device="cuda")
        xbc[..., di:] *= 0.3
        xbc = xbc.to(dt_)
        x, Bm, Cm = split(xbc)
    else:
        x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dt_)
        Bm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(dt_)
        Cm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(dt_)
    if law:
        dt, A = model_law(torch, g, B, S, H)
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=g, device="cuda"))
        A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    if length is not None:
        x[:, length:] = 0
        dt[:, length:] = 0
    y, st = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yr, sr = ssd_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    errs, scaled = [], []
    for got, want in ((y, yr), (st, sr)):
        e = float((got.float() - want.float()).abs().max())
        errs.append(e)
        scaled.append(e / (float(want.float().abs().max()) + 1e-9))
        check(bool(torch.isfinite(got).all()), "ssd_scan: non-finite output")
    check(max(scaled) <= SSD_TOL[dtype],
          f"ssd_scan disagrees with its plain version at B={B} S={S} H={H} "
          f"P={P} N={N} {dtype} length={length} law={law}: scale-normalised "
          f"errors "
          f"{scaled}")
    if length is not None:
        _, s_short = ssd_ref(x[:, :length], dt[:, :length], A,
                             Bm[:, :length], Cm[:, :length])
        e = float((st - s_short).abs().max()) / (
            float(s_short.abs().max()) + 1e-9)
        check(e <= SSD_TOL[dtype],
              f"ssd_scan: the pad tail moved the final state ({e})")
    row = {"shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk}",
           "dtype": dtype, "length": length, "fused": fused, "law": law,
           "max_abs_err": max(errs), "scaled_err_y": scaled[0],
           "scaled_err_state": scaled[1]}
    if not timed:
        return row
    # bytes: x, dt, A, B, C read once, y and the state written once;
    # operations: per chunk of L rows the causal half of C.B (shared by
    # the heads), and per head the intra-chunk, inter-chunk and state
    # products
    esz = x.element_size()
    L = min(chunk, S)
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * esz \
        + (B * S * H + H + B * H * P * N) * 4
    flops = float(B * (S // L)) * (L * (L + 1) * N
                                    + H * (L * (L + 1) * P + 4 * L * N * P))
    sets = copies(torch, (xbc, dt), xbc.numel() * esz + dt.numel() * 4)

    def on_views(fn):
        def call(xbc_, dt_):
            x_, b_, c_ = split(xbc_)
            return fn(x_, dt_, A, b_, c_)
        return call

    ms = cuda_ms(torch, on_views(partial(sops.ssd_scan, chunk=chunk)), sets)
    plain_ms = cuda_ms(torch, on_views(ssd_ref), sets, iters=5)
    dev_ms, host_ms = queued_ms(
        torch, on_views(partial(sops.ssd_scan, chunk=chunk)), sets)
    by_kernel = device_ms_by_kernel(
        torch, lambda: sops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=None, bytes=nbytes, flops=flops,
               library_note="no single PyTorch call computes the SSD scan",
               device_ms_by_kernel=by_kernel)
    row.update(ratios(row))
    return row


def lm_head_case(torch):
    """The LM head at a decode step's shape (8 slots, llama-3.1-8b's
    4096 x 128256 bf16 head), through the model's ``lm_logits``, held
    against the float32 upcast of both operands that it replaced (timed
    too, as ``upcast_ms``), with the bytes bound of reading the head."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models import model as M

    cfg = REGISTRY["llama-3.1-8b"]
    g = torch.Generator(device="cuda").manual_seed(5)
    head = (torch.randn((cfg.d_model, cfg.vocab_size), generator=g,
                        device="cuda") * 0.02).to(torch.bfloat16)
    h = torch.randn((SLOTS, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    params = {"lm_head": head}
    got = M.lm_logits(params, cfg, h)
    want = h.float() @ head.float()
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, "bfloat16")
    check(ok and got.dtype == torch.float32,
          f"lm_logits disagrees with the float32 upcast: max abs err {err}")
    sets = [(h,)]
    nbytes = head.numel() * 2 + h.numel() * 2 + got.numel() * 4
    flops = 2.0 * SLOTS * cfg.d_model * cfg.vocab_size
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    ms = cuda_ms(torch, lambda x: M.lm_logits(params, cfg, x), sets)
    dev_ms, host_ms = queued_ms(torch, lambda x: M.lm_logits(params, cfg, x),
                                sets)
    upcast_ms = cuda_ms(torch, lambda x: x.float() @ head.float(), sets)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    M.lm_logits(params, cfg, h)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    row = {"shape": f"B={SLOTS} d={cfg.d_model} V={cfg.vocab_size} bf16 -> "
                    "float32", "max_abs_err": err, "ms": ms,
           "device_ms": dev_ms, "host_ms": host_ms, "upcast_ms": upcast_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "extra_memory_gb": extra / 1e9,
           "head_gb": head.numel() * 2 / 1e9}
    print("lm_head: " + json.dumps(row))
    return row


def kernel_phase(torch, F):
    """Every kernel at the main paths' shapes, both dtypes; returns the
    headline row per kernel (bf16 at the largest shape) and the largest
    error against the plain version per kernel."""
    llama = dict(Hq=32, Hkv=8, Dh=128)
    drafter = dict(Hq=2, Hkv=2, Dh=16)  # make_draft_config at full width
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
        # the paged prefill: suffixes after prefix hits of 0, 256, 496
        for q_start in (0, 256, 496):
            flash_rows.append(flash_case(
                torch, F, 1, 512, dtype=dtype, kv_frac=2 / 3, window=None,
                softcap=None, timed=dtype == "bfloat16", q_start=q_start,
                **llama))
        flash_rows.append(flash_case(
            torch, F, 1, 512, dtype=dtype, kv_frac=2 / 3, window=None,
            softcap=None, timed=False, **drafter))
    # one rank's shard of llama at tp=2 (phase 9)
    shard = dict(Hq=llama["Hq"] // MESH_TP, Hkv=llama["Hkv"] // MESH_TP,
                 Dh=llama["Dh"])
    decode_rows, decode_shard_rows = [], []
    for dtype in ("bfloat16", "float32"):
        decode_rows.append(decode_case(
            torch, F, SLOTS, MAX_LEN, dtype=dtype, window=None, softcap=None,
            timed=(dtype == "bfloat16"), **llama))
        decode_shard_rows.append(decode_case(
            torch, F, SLOTS, MAX_LEN, dtype=dtype, window=None, softcap=None,
            timed=(dtype == "bfloat16"), **shard))
        decode_rows.append(decode_case(
            torch, F, 3, 256, 8, 2, 64, dtype=dtype, window=48, softcap=30.0,
            timed=False))
        decode_rows.append(decode_case(
            torch, F, SLOTS, MAX_LEN, dtype=dtype, window=None, softcap=None,
            timed=False, **drafter))
        decode_rows.append(ring_empty_case(torch, dtype))
    # ragged rows: full, page boundaries, short, and one empty slot
    lengths = [1024, 700, 513, 512, 300, 17, SPEC_K + 2, 0]
    paged_rows = {1: [], SPEC_K + 1: []}
    paged_shard_rows = {1: [], SPEC_K + 1: []}
    for dtype in ("bfloat16", "float32"):
        for T in paged_rows:
            paged_rows[T].append(paged_case(
                torch, F, SLOTS, T, lengths=lengths, dtype=dtype, window=None,
                softcap=None, timed=dtype == "bfloat16", **llama))
            paged_shard_rows[T].append(paged_case(
                torch, F, SLOTS, T, lengths=lengths, dtype=dtype, window=None,
                softcap=None, timed=dtype == "bfloat16", **shard))
            paged_rows[T].append(paged_case(
                torch, F, 3, T, 8, 2, 64, [40, 0, 17], dtype=dtype,
                window=24, softcap=30.0, timed=False, Pmax=4, pool_pages=24))
    # the dense family's heads (phases 10-12), untimed: ministral-3b and
    # phi4-mini (G = 3; also a query offset and the paged kernel at the
    # spec phase's T), qwen3-32b and chameleon (G = 8), minicpm (MHA at
    # head dim 64); command-r-plus's G = 12, which the paged wrapper runs
    # as two sub-groups of heads at T = SPEC_K + 1
    family = [dict(Hq=24, Hkv=8, Dh=128), dict(Hq=64, Hkv=8, Dh=128),
              dict(Hq=36, Hkv=36, Dh=64)]
    for dtype in ("bfloat16", "float32"):
        for heads in family:
            flash_rows.append(flash_case(
                torch, F, 1, 512, dtype=dtype, kv_frac=2 / 3, window=None,
                softcap=None, timed=False, **heads))
            decode_rows.append(decode_case(
                torch, F, SLOTS, MAX_LEN, dtype=dtype, window=None,
                softcap=None, timed=False, **heads))
        flash_rows.append(flash_case(
            torch, F, 1, 512, dtype=dtype, kv_frac=2 / 3, window=None,
            softcap=None, timed=False, q_start=256, **family[0]))
        for T in paged_rows:
            for heads in (family[0], dict(Hq=96, Hkv=8, Dh=128)):
                paged_rows[T].append(paged_case(
                    torch, F, SLOTS, T, lengths=lengths, dtype=dtype,
                    window=None, softcap=None, timed=False, **heads))
    # the SSD scan: the sweep of tests/test_kernels.py:237, the reduced
    # config's dims, and mamba2-2.7b's prefill at S=512 (x, B and C
    # slices of one tensor, as the model passes them; timed), also with
    # a pad tail and with dt and A under the model's law
    ssd_rows = []
    mamba = dict(B=1, S=512, H=80, P=64, N=128, chunk=256)
    for dtype in ("bfloat16", "float32"):
        for B, S, H, P, N, chunk in ((2, 256, 4, 64, 128, 64),
                                     (1, 512, 8, 32, 64, 128),
                                     (2, 128, 2, 64, 32, 128),
                                     (1, 96, 4, 16, 16, 32)):
            ssd_rows.append(ssd_case(torch, B, S, H, P, N, chunk, dtype,
                                     timed=False))
        ssd_rows.append(ssd_case(torch, dtype=dtype, fused=True,
                                 timed=dtype == "bfloat16", **mamba))
        ssd_rows.append(ssd_case(torch, dtype=dtype, fused=True, length=300,
                                 timed=False, **mamba))
        ssd_rows.append(ssd_case(torch, dtype=dtype, fused=True, law=True,
                                 timed=False, **mamba))
    rows = {"flash_prefill": flash_rows, "ring_decode": decode_rows,
            "paged_decode": paged_rows[1],
            "paged_verify": paged_rows[SPEC_K + 1], "ssd_scan": ssd_rows,
            "ring_decode@shard": decode_shard_rows,
            "paged_decode@shard": paged_shard_rows[1],
            "paged_verify@shard": paged_shard_rows[SPEC_K + 1]}
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name}: " + json.dumps(r))
    print("ssd_scan worst scale-normalised error, y / state, by dtype: "
          + json.dumps({d: [max(r[k] for r in ssd_rows if r["dtype"] == d)
                            for k in ("scaled_err_y", "scaled_err_state")]
                        for d in ("bfloat16", "float32")}))
    head = {name: next(r for r in rs if "ms" in r)
            for name, rs in rows.items()}
    errs = {name: {dtype: max(r["max_abs_err"] for r in rs
                              if r["dtype"] == dtype)
                   for dtype in ("bfloat16", "float32")}
            for name, rs in rows.items()}
    return head, errs


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


def serve_phase(torch, arch, label, per_iter, params=None, tp=0,
                cuda_graphs=None):
    """``arch`` at full width and depth in bf16 (random weights from a
    seeded generator) through the dense P/D cluster, one prefill and one
    decode instance, on 8 Poisson requests.  ``per_iter`` maps each
    kernel the path runs to the iteration kind ("prefill" or "decode")
    that launches it once per layer; every other kernel must stay at 0.
    With ``tp`` the instances are tp-wide slices of the world and
    ``params`` this rank's shards.  ``cuda_graphs`` goes to the backends
    (None: graphs for a meshless decode instance).  Returns the config,
    params, requests, this run's launch counts and the printed stats."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
    from repro_torch.serving import jitcache, loopprof
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_real_backend_factory
    from repro_torch.serving.workload import (
        DatasetDist, LengthDist, attach_tokens,
    )

    cfg = REGISTRY[arch]
    if params is None:
        cfg, params = init_model(torch, arch)
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
                                     max_len=MAX_LEN, tp=tp, device="cuda",
                                     cuda_graphs=cuda_graphs)

    def factory(kind, idx, hw, seed, tp=None):
        be = base(kind, idx, hw, seed, tp=tp)
        be._real_prefill = timed(torch, be._real_prefill, walls["prefill"])
        be._real_decode_step = timed(torch, be._real_decode_step,
                                     walls["decode"])
        return be

    ccfg = ClusterConfig(
        model=cfg, chip=A100, n_prefill=1, n_decode=1, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=SLOTS, seed=0, tp=max(tp, 1),
        backend_factory=factory,
    )
    cluster = PDCluster(ccfg)
    prof = loopprof.install(cluster)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    fops.launches = fops.q_offset_launches = 0
    dops.launches = 0
    dops.paged_launches.clear()
    dops.sharded_launches.clear()
    sops.launches = 0
    graphs0 = (jitcache.capture_count(), jitcache.replay_count())
    t0 = time.perf_counter()
    m = cluster.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    graphs = graph_counts(jitcache, graphs0, cuda_graphs, tp, 1,
                          len(walls["decode"]), label)
    launches = {"flash_prefill": fops.launches,
                "flash_prefill_q_offset": fops.q_offset_launches,
                "ring_decode": dops.launches,
                "paged": sum(dops.paged_launches.values()),
                "ssd_scan": sops.launches}
    peak = torch.cuda.max_memory_allocated()

    check(m.finished_frac() == 1.0, f"{label}: finished {m.finished_frac()}")
    for r in reqs:
        check(len(r.output_tokens) == r.decode_len + 1,
              f"{label}: request {r.rid}: {len(r.output_tokens)} tokens, "
              f"expected {r.decode_len + 1}")
        check(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"{label}: request {r.rid}: token id out of range")
    for name, n in launches.items():
        kind = per_iter.get(name)
        want = cfg.n_layers * len(walls[kind]) if kind else 0
        check(n == want and (n > 0 or not kind),
              f"{label}: {name} launched {n} times, expected {want}")
    n_dec = sum(r.decode_len for r in reqs)
    dec_s = sum(walls["decode"]) / 1e3
    s = m.summary()
    print(f"{label}: served {len(reqs)} requests (prompts "
          f"{min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)}, decode "
          f"{min(r.decode_len for r in reqs)}-"
          f"{max(r.decode_len for r in reqs)}) in {wall_s:.2f} s wall")
    stats = {
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
        "sharded_launches": sharded_counts(dops),
        **graphs, **loop_split(prof),
        "step_device_ms": (step_device_ms(torch, cluster)
                           if graphs["cuda_graphs"] else None),
    }
    print(f"serve[{label}]: " + json.dumps(stats))
    print(f"{label}: virtual-clock A100 model (not measured on this card): "
          f"ttft_p50_ms={s['ttft_p50_ms']} itl_p50_ms={s['itl_p50_ms']} "
          f"energy_j={s['energy_j']} epot_mj={s['epot_mj']}")
    return cfg, params, reqs, launches, stats


def graph_counts(jitcache, before, cuda_graphs, tp, entries, steps, label):
    """The run's graph captures and replays (``before``: the counts at its
    start), checked: a meshless decode instance with graphs on captures
    one graph per step entry it used (``entries``) and replays every
    later step (``steps`` in all); otherwise nothing is captured."""
    captures = jitcache.capture_count() - before[0]
    replays = jitcache.replay_count() - before[1]
    on = cuda_graphs is not False and not tp
    want = (entries, steps - entries) if on else (0, 0)
    check((captures, replays) == want and (replays > 0 or not on),
          f"{label}: {captures} graph captures and {replays} replays, "
          f"expected {want[0]} and {want[1]}")
    return {"cuda_graphs": on, "captures": captures, "replays": replays}


def step_device_ms(torch, cluster):
    """Device ms of one replay of each step graph the decode instances
    captured, replayed back to back behind a sleep (:func:`queued_ms`)
    on the inputs of the run's last step, after the run: the device time
    of a step, which its iteration wall holds beside the host's part.
    {entry: ms}."""
    out = {}
    for e in cluster.decode:
        be = e.backend
        names = {id(be._decode_fn): "decode"}
        if be.spec_k:
            names.update({id(be._draft_fn): "draft",
                          id(be._verify_fn): "verify"})
        for (entry, _), graph in be._graphs._graphs.items():
            out[names[id(entry)]] = queued_ms(
                torch, graph.graph.replay, [()])[0]
    return out


def loop_split(prof):
    """loopprof's dispatch / device-wait split of the run, seconds."""
    bd = prof.breakdown()
    return {"dispatch_s": bd["dispatch_s"],
            "device_wait_s": bd["device_wait_s"]}


def same_streams_eagerly(torch, reqs, arch, label, per_iter, params):
    """Serve the workload of ``reqs`` again with every step eager
    (``cuda_graphs=False``, the graphs' oracle) on the same weights: the
    token streams must be equal, since the same kernels run on the same
    inputs."""
    _, _, eager, _, _ = serve_phase(torch, arch, f"{label}-eager", per_iter,
                                    params=params, cuda_graphs=False)
    same = [r.output_tokens == e.output_tokens for r, e in zip(reqs, eager)]
    check(len(eager) == len(reqs) and all(same),
          f"{label}: graph replay and eager steps emitted different streams "
          f"(requests {[r.rid for r, ok in zip(reqs, same) if not ok]})")
    print(f"{label}: the eager serve emitted the same {len(reqs)} streams "
          "as the graph replays")
    free(torch)


def sharded_counts(dops):
    """The sharded wrappers' launches on this rank, "wrapper/hkvN"."""
    return {f"{name}/hkv{h}": n
            for (name, h), n in sorted(dops.sharded_launches.items())}


def timed(torch, fn, out):
    """``fn`` with its synchronised wall milliseconds appended to ``out``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
        return res
    return run


def free(torch):
    """Return freed tensors' memory to the card (the caching allocator
    keeps it otherwise)."""
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 5: replay through the plain-attention path
# ---------------------------------------------------------------------------


def replay_phase(torch, models, r, kinds=None):
    """Replay ``r``'s stream through the plain-attention path of each
    model in ``models`` (name -> (cfg, params)), prompt first, then every
    emitted token.  Token i must be within ``REPLAY_MARGIN`` of the max
    logit of the model named ``kinds[i]`` (the first model's, by
    default): the one that chose it."""
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import _bucket

    names = list(models)
    kinds = kinds or [names[0]] * len(r.output_tokens)
    check(len(kinds) == len(r.output_tokens),
          f"rid {r.rid}: {len(kinds)} token kinds for "
          f"{len(r.output_tokens)} tokens")
    toks = torch.tensor(r.prompt_tokens, dtype=torch.int32, device="cuda")
    pad = _bucket(len(toks), hi=MAX_LEN)
    buf = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    buf[0, : len(toks)] = toks
    lengths = torch.tensor([len(toks)], dtype=torch.int32, device="cuda")
    state = {}
    for name, (cfg, params) in models.items():
        state[name] = M.prefill(params, cfg, buf, lengths, max_len=MAX_LEN,
                                plain_attention=True)
    pos = lengths.clone()
    worst = {name: 0.0 for name in names}
    for i, (tok, kind) in enumerate(zip(r.output_tokens, kinds)):
        row = state[kind][0][0].double()
        gap = float(row.max() - row[tok])
        worst[kind] = max(worst[kind], gap)
        check(gap <= REPLAY_MARGIN,
              f"rid {r.rid} token {i} ({kind}): emitted id {tok} is "
              f"{gap:.4f} below the plain path's max logit (margin "
              f"{REPLAY_MARGIN})")
        t = torch.tensor([tok], dtype=torch.int32, device="cuda")
        for name, (cfg, params) in models.items():
            state[name] = M.decode_step(params, cfg, t, state[name][1], pos,
                                        plain_attention=True)
        pos = pos + 1
    counts = {name: kinds.count(name) for name in names}
    print(f"replay rid {r.rid}: {len(r.output_tokens)} tokens {counts}, "
          f"worst gap to the plain path's max logit {worst} (margin "
          f"{REPLAY_MARGIN})")


def state_phase(torch, cfg, params, r, label, whole_path: bool):
    """``r``'s prompt at its served bucket, prefilled through the kernel
    path and through the plain ``L.ssd_chunked`` path.

    Per layer, ``ssd_scan``'s y and final state are held against
    ``L.ssd_chunked`` on the very inputs the kernel path gave that layer.
    Along the whole path, each layer's prefill state (``ssm``) of the
    one path is held against the other's: in every layer with
    ``whole_path``, else in layer 0 only, whose input both paths share
    (deeper, each path's own bf16 rounding of y feeds the next layer,
    and the gap grows where the scan dominates y).  All errors are
    scale-normalised, to the scan's bf16 tolerance."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import _bucket

    n = len(r.prompt_tokens)
    buf = torch.zeros((1, _bucket(n, hi=MAX_LEN)), dtype=torch.int32,
                      device="cuda")
    buf[0, :n] = torch.tensor(r.prompt_tokens, dtype=torch.int32,
                              device="cuda")
    lengths = torch.tensor([n], dtype=torch.int32, device="cuda")
    seen, kernel = [], M.ssd_scan

    def spy(*a, **k):
        out = kernel(*a, **k)
        seen.append((a, k, out))
        return out

    M.ssd_scan = spy
    try:
        lk, ck = M.prefill(params, cfg, buf, lengths, max_len=MAX_LEN)
    finally:
        M.ssd_scan = kernel
    lp, cp = M.prefill(params, cfg, buf, lengths, max_len=MAX_LEN,
                       plain_attention=True)
    check(len(seen) == cfg.n_layers,
          f"state[{label}]: {len(seen)} scans for {cfg.n_layers} layers")

    def scaled(got, want):
        return float((got.float() - want.float()).abs().max()) / (
            float(want.float().abs().max()) + 1e-30)

    per_layer = []
    for a, k, (y, st) in seen:
        yr, sr = L.ssd_chunked(*a, **k)
        per_layer.append(max(scaled(y, yr), scaled(st, sr)))
    sk, sp = ck["layer_0"]["ssm"], cp["layer_0"]["ssm"]  # (layers, 1, ...)
    dims = tuple(range(1, sp.dim()))
    scale = sp.abs().amax(dim=dims)
    path = ((sk - sp).abs().amax(dim=dims) / (scale + 1e-30)).tolist()
    held = path if whole_path else path[:1]
    tol = SSD_TOL["bfloat16"]
    print(f"state[{label}]: rid {r.rid} prompt {n} at bucket "
          f"{buf.shape[1]}: ssm scale {float(scale.min()):.3g}-"
          f"{float(scale.max()):.3g}; same inputs, worst layer "
          f"{max(per_layer):.3g}; whole path, layers 0, 8, ..., 56: "
          f"{[float(f'{e:.3g}') for e in path[::8]]}, worst "
          f"{max(path):.3g} (layer {path.index(max(path))}), held in "
          f"{'every layer' if whole_path else 'layer 0'}; tolerance {tol}; "
          f"logits max gap {float((lk - lp).abs().max()):.4g}")
    check(max(per_layer) <= tol,
          f"state[{label}]: ssd_scan disagrees with L.ssd_chunked on a "
          f"layer's own inputs ({max(per_layer)})")
    check(bool(torch.isfinite(sk).all()) and max(held) <= tol,
          f"state[{label}]: the kernel path's SSM state disagrees with the "
          f"plain path's ({max(held)})")


# ---------------------------------------------------------------------------
# Phases 6 and 7: paged serving, then paged + speculative
# ---------------------------------------------------------------------------


def multiturn_workload(Request, vocab: int, n_convs=2, n_turns=3,
                       system_len=256, seed=3):
    """Conversations after a shared system prompt, each turn extending
    the last (prompt + the previous turn's reply + a new user message),
    at the full vocabulary (as tests/test_backend_parity.py:317 builds
    it).  The radix cache matches whole pages of the previous prompt."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def ids(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    def between(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    system = ids(system_len)
    hist = {c: list(system) for c in range(n_convs)}
    reqs, rid = [], 0
    for turn in range(n_turns):
        for c in range(n_convs):
            prompt = hist[c] + ids(between(16, 48))
            decode = between(16, 32)
            r = Request(rid, 2.0 * turn + 0.3 * c, prompt_len=len(prompt),
                        decode_len=decode, conv_id=c, turn=turn)
            r.prompt_tokens = list(prompt)
            reqs.append(r)
            rid += 1
            hist[c] = prompt + ids(decode)  # the reply, as the user saw it
    return reqs


def _radix_pages(cache):
    pages, stack = [], [cache.root]
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        pages.extend(n.pages)
    return pages


def paged_serve_phase(torch, cfg, params, pred, drafter=None, tp=0,
                      label=None):
    """Serve the multi-turn workload over the paged pool with a radix
    prefix cache; with ``drafter`` (cfg, params) the decode instance
    speculates ``SPEC_K`` tokens per iteration; with ``tp`` the instances
    are tp-wide slices (``params`` this rank's shards).  Returns the
    requests, the (rid, accepted) log of the speculative iterations, the
    launch counts of this run and the printed stats."""
    from repro_torch.core.power import A100
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.serving import ClusterConfig, PDCluster, Request
    from repro_torch.serving import jitcache, loopprof
    from repro_torch.serving.realengine import make_real_backend_factory

    phase = label or ("spec" if drafter else "paged")
    spec_k = SPEC_K if drafter else 0
    reqs = multiturn_workload(Request, cfg.vocab_size)
    walls = {"prefill": [], "decode": [], "spec": []}
    log = []
    base = make_real_backend_factory(
        cfg, params, slots=SLOTS, max_len=MAX_LEN, paged=True,
        page_size=PAGE_SIZE, pool_pages=POOL_PAGES, spec_k=spec_k,
        draft_cfg=drafter[0] if drafter else None,
        draft_params=drafter[1] if drafter else None, tp=tp, device="cuda")

    def factory(kind, idx, hw, seed, tp=None):
        be = base(kind, idx, hw, seed, tp=tp)
        be._real_prefill = timed(torch, be._real_prefill, walls["prefill"])
        be._real_decode_step = timed(torch, be._real_decode_step,
                                     walls["decode"])
        if be.spec_k:
            inner = timed(torch, be._real_spec_step, walls["spec"])

            def step(rs, k, accepts):
                log.extend((r.rid, a) for r, a in zip(rs, accepts))
                return inner(rs, k, accepts)

            be._real_spec_step = step
        return be

    cluster = PDCluster(ClusterConfig(
        model=cfg, chip=A100, n_prefill=1, n_decode=1, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=SLOTS, seed=0, paged=True,
        kv_page_size=PAGE_SIZE, prefix_cache=True,
        prefix_cache_capacity=8_192, spec_decode=bool(drafter),
        spec_k=SPEC_K, tp=max(tp, 1), backend_factory=factory,
    ))
    prof = loopprof.install(cluster)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    fops.launches = fops.q_offset_launches = 0
    dops.launches = 0
    dops.paged_launches.clear()
    dops.sharded_launches.clear()
    graphs0 = (jitcache.capture_count(), jitcache.replay_count())
    t0 = time.perf_counter()
    m = cluster.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # a speculative iteration steps the drafter k + 1 times, then verifies
    graphs = graph_counts(
        jitcache, graphs0, None, tp, 2 if drafter else 1,
        len(walls["spec"]) * (SPEC_K + 2) if drafter
        else len(walls["decode"]), phase)
    launches = {
        "flash_prefill": fops.launches,
        "flash_prefill_q_offset": fops.q_offset_launches,
        "ring_decode": dops.launches,
        "paged_decode": dops.paged_launches.get(1, 0),
        "paged_verify": sum(n for t, n in dops.paged_launches.items()
                            if t > 1),
        "paged_by_T": dict(dops.paged_launches),
    }
    peak = torch.cuda.max_memory_allocated()

    check(m.finished_frac() == 1.0, f"{phase}: finished {m.finished_frac()}")
    for r in reqs:
        check(len(r.output_tokens) == r.decode_len + 1,
              f"{phase}: request {r.rid}: {len(r.output_tokens)} tokens, "
              f"expected {r.decode_len + 1}")
        check(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"{phase}: request {r.rid}: token id out of range")
    pb = cluster.prefill[0].backend
    total_prompt = sum(r.prompt_len for r in reqs)
    check(pb.reused_tokens > 0, f"{phase}: no prefix reuse")
    check(pb.computed_tokens == total_prompt - pb.reused_tokens,
          f"{phase}: computed {pb.computed_tokens} + reused "
          f"{pb.reused_tokens} != prompts {total_prompt}")
    for e in cluster.decode:
        e.backend.pool.assert_empty()
    radix = _radix_pages(cluster.prefill[0].cache)
    check(pb.pool.in_use == len(set(radix)),
          f"{phase}: prefill pool holds {pb.pool.in_use} pages, its radix "
          f"tree {len(set(radix))}")
    check(launches["flash_prefill_q_offset"] > 0,
          f"{phase}: the q-offset flash_prefill was never launched")
    if drafter:
        check(m.spec_iterations() > 0, "spec: no speculative iteration")
        check(dops.paged_launches.get(SPEC_K + 1, 0) > 0,
              f"spec: paged_verify never launched at T={SPEC_K + 1}")
    else:
        check(launches["paged_decode"] > 0,
              "paged: paged_decode was never launched")
    iters = walls["spec"] if drafter else walls["decode"]
    n_dec = sum(r.decode_len for r in reqs)
    dec_s = sum(iters) / 1e3
    s = m.summary()
    print(f"{phase}: served {len(reqs)} requests (prompts "
          f"{min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)}, decode "
          f"{min(r.decode_len for r in reqs)}-"
          f"{max(r.decode_len for r in reqs)}) in {wall_s:.2f} s wall")
    stats = {
        "requests": len(reqs),
        "prompt_tokens": total_prompt,
        "reused_tokens": pb.reused_tokens,
        "computed_tokens": pb.computed_tokens,
        "prefill_iters": len(walls["prefill"]),
        "prefill_ms_mean": statistics.fmean(walls["prefill"]),
        "prefill_ms_median": statistics.median(walls["prefill"]),
        "iter_kind": "spec" if drafter else "decode",
        "iters": len(iters),
        "iter_ms_mean": statistics.fmean(iters),
        "iter_ms_median": statistics.median(iters),
        "decode_tokens": n_dec,
        "decode_tok_s": n_dec / dec_s if dec_s else None,
        "spec_iterations": m.spec_iterations(),
        "acceptance_rate": m.acceptance_rate() if drafter else None,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "sharded_launches": sharded_counts(dops),
        **graphs, **loop_split(prof),
        "step_device_ms": (step_device_ms(torch, cluster)
                           if graphs["cuda_graphs"] else None),
    }
    print(f"serve[{phase}]: " + json.dumps(stats))
    print(f"{phase}: virtual-clock A100 model (not measured on this card): "
          f"ttft_p50_ms={s['ttft_p50_ms']} itl_p50_ms={s['itl_p50_ms']} "
          f"energy_j={s['energy_j']}")
    return reqs, log, launches, stats


# ---------------------------------------------------------------------------
# Phase 9: tensor-parallel slices, two ranks sharing the card
# ---------------------------------------------------------------------------

def _streams(reqs):
    return [{"rid": r.rid, "prompt_tokens": list(r.prompt_tokens),
             "output_tokens": list(r.output_tokens)} for r in reqs]


def mesh_rank(rank: int, world: int, init: str, out: str, pred) -> None:
    """Phase 9 on one rank: join the world, hold the sharded wrappers
    against their plain versions, build this rank's shards of llama and
    the drafter, and serve dense, paged and speculative through tp-wide
    slices.  Writes its results (or its traceback) to ``out``."""
    import pickle
    import traceback

    # whole lines, not mixed with the other rank's: buffer each line and
    # write it at once, even under PYTHONUNBUFFERED
    sys.stdout.reconfigure(line_buffering=True, write_through=False)
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch
    import torch.distributed as dist

    res = {"ok": False}
    try:
        from repro_torch.configs.registry import REGISTRY
        from repro_torch.distributed import init_world, make_slice_mesh
        from repro_torch.models import model as M
        from repro_torch.serving.realengine import make_draft_config
        from _mesh_worlds import check_sharded_wrappers

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["backend"] = init_world(rank, world, init, "cuda",
                                    timeout_s=300.0)
        mesh = make_slice_mesh(range(world), "cuda")
        res["wrappers"] = check_sharded_wrappers(torch, mesh)
        res["collectives"] = time_collectives(torch, mesh)
        res["wrapper_wall"] = time_sharded_wrapper(torch, mesh)
        cfg = REGISTRY["llama-3.1-8b"]
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(cfg, gen, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        res["local_params"] = sum(t.numel() for t in _leaves(params))
        serves = {}
        _, _, reqs, _, stats = serve_phase(
            torch, "llama-3.1-8b", f"mesh-dense rank {rank}",
            {"flash_prefill": "prefill", "ring_decode": "decode"},
            params=params, tp=world)
        serves["dense"] = (_streams(reqs), [], stats)
        reqs, log, _, stats = paged_serve_phase(
            torch, cfg, params, pred, tp=world,
            label=f"mesh-paged rank {rank}")
        serves["paged"] = (_streams(reqs), log, stats)
        dcfg = make_draft_config(cfg)
        dparams = M.init_params(
            dcfg, torch.Generator(device="cuda").manual_seed(1),
            device="cuda", mesh=mesh)
        reqs, log, _, stats = paged_serve_phase(
            torch, cfg, params, pred, drafter=(dcfg, dparams), tp=world,
            label=f"mesh-spec rank {rank}")
        serves["spec"] = (_streams(reqs), log, stats)
        res.update(serves=serves, ok=True)
    except BaseException:  # the parent fails the phase with it
        res["error"] = traceback.format_exc()
    Path(out).write_bytes(pickle.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()


def time_collectives(torch, mesh, iters: int = 50):
    """Synchronised wall ms per call of the model's two collectives on
    this world's backend, at a decode step's shapes: the sum of one
    row-parallel output (8 slots x 4096, bf16) and the gather of the
    logits' vocabulary shards (8 x 128256 / tp, float32)."""
    from repro_torch.distributed.context import (
        gather_model, mesh_context, reduce_model,
    )

    x = torch.zeros((SLOTS, 4096), dtype=torch.bfloat16, device="cuda")
    logits = torch.zeros((SLOTS, 128256 // MESH_TP), device="cuda")
    out = {}
    with mesh_context(mesh):
        for name, fn in (("all_reduce 8x4096 bf16", lambda: reduce_model(x)),
                         ("gather 8x64128 f32",
                          lambda: gather_model(logits))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def time_sharded_wrapper(torch, mesh, iters: int = 50):
    """Synchronised wall ms a call of each sharded wrapper (bf16, main
    shapes, this rank's half of the heads) by each route: "local" is the
    sharded branch as the model calls it (``ops.on_local_heads``),
    "dtensor" the wrapper fed DTensors and returning one, "unsharded"
    the unsharded wrapper on the same local views.  {kind: {route:
    ms}}."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.decode_attention import ops as dops
    from _mesh_worlds import _wrapper, main_shape_inputs

    i, w = mesh.get_local_rank("model"), MESH_TP
    out = {}
    for kind in ("decode", "paged_decode", "paged_verify"):
        fn, qd = _wrapper(kind)
        q, k, v, *rest = main_shape_inputs(torch, kind, "bfloat16", "cuda")
        local = [t.chunk(w, dim=d)[i].contiguous()
                 for t, d in ((q, qd), (k, 2), (v, 2))]

        def placed():
            return [DTensor.from_local(t, mesh, (Replicate(), Shard(d)),
                                       run_check=False)
                    for t, d in zip(local, (qd, 2, 2))]

        calls = {
            "local": lambda: dops.on_local_heads(fn, *local, *rest,
                                                 mesh=mesh),
            "dtensor": lambda: fn(*placed(), *rest, mesh=mesh).to_local(),
            "unsharded": lambda: fn(*local, *rest),
        }
        out[kind] = {}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
            out[kind][name] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def mesh_phase(torch, pred):
    """Spawn the phase 9 world and check what its ranks report: the
    sharded wrappers' errors and launches, every serve's completeness
    and launches, and the same streams on every rank.  Returns rank 0's
    results."""
    import multiprocessing as mp
    import pickle
    import tempfile

    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    sys.stdout.flush()  # the ranks write to the same stream
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.pkl" for r in range(MESH_TP)]
        procs = [ctx.Process(target=mesh_rank, args=(
            r, MESH_TP, f"file://{tmp}/store", str(outs[r]), pred))
            for r in range(MESH_TP)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        ranks = [pickle.loads(o.read_bytes()) if o.exists() else
                 {"ok": False, "error": f"no result (exit {p.exitcode})"}
                 for o, p in zip(outs, procs)]
    for r, res in enumerate(ranks):
        if not res["ok"]:
            print(f"mesh rank {r} failed:\n{res['error']}", file=sys.stderr)
    check(not hung, f"mesh: ranks {hung} outlasted {MESH_TIMEOUT_S} s")
    check(all(res["ok"] for res in ranks), "mesh: a rank failed")
    print(f"mesh: {MESH_TP} ranks on one card, {ranks[0]['backend']} "
          f"backend, {ranks[0]['local_params']:,} llama params per rank "
          f"(init {ranks[0]['init_s']:.1f} s), "
          f"{time.perf_counter() - t0:.1f} s wall")
    print("mesh collectives, synchronised wall ms a call, per rank "
          "(a dense decode step makes 65 all-reduces and 1 gather): "
          + json.dumps({k: [res["collectives"][k] for res in ranks]
                        for k in ranks[0]["collectives"]}))
    print("mesh sharded wrappers, synchronised wall ms a call, per rank "
          "(local: the sharded branch as the model calls it; dtensor: "
          "DTensors in and out; unsharded: the unsharded wrapper on the "
          "same local views): " + json.dumps(
              {k: {r: [res["wrapper_wall"][k][r] for res in ranks]
                   for r in ranks[0]["wrapper_wall"][k]}
               for k in ranks[0]["wrapper_wall"]}))
    hkv = 8 // MESH_TP
    check(all(res["wrappers"]["empty"] == {} for res in ranks),
          "mesh: an empty batch counted sharded launches: "
          f"{[res['wrappers']['empty'] for res in ranks]}")
    for kind in ("decode", "paged_decode", "paged_verify"):
        for dtype in ("bfloat16", "float32"):
            errs = [e for res in ranks
                    for e in res["wrappers"][kind][dtype].values()]
            check(all(ok for _, ok, _ in errs),
                  f"mesh: sharded {kind} disagrees with its plain version "
                  f"in {dtype}: {[e for e, _, _ in errs]}")
            check(all(n == {hkv: 1} for _, _, n in errs),
                  f"mesh: sharded {kind} launches {[n for *_, n in errs]}")
        print(f"mesh wrapper {kind}: max abs err vs plain on the full "
              f"tensors, by route " + json.dumps(
                  {d: {r: max(res["wrappers"][kind][d][r][0]
                              for res in ranks)
                       for r in ranks[0]["wrappers"][kind][d]}
                   for d in ("bfloat16", "float32")}))
    # each serve's sharded wrapper, at the kv heads of one rank's shard
    wrapper = {serve: name.split("(")[0]
               for name, (_, _, serve, _) in WRAPPERS.items()}
    for name in ("dense", "paged", "spec"):
        per = [res["serves"][name] for res in ranks]
        check(all(p[0] == per[0][0] for p in per),
              f"mesh-{name}: the ranks emitted different streams")
        check(all(p[1] == per[0][1] for p in per),
              f"mesh-{name}: the ranks accepted different drafts")
        key = f"{wrapper[name]}/hkv{hkv}"
        for r, (_, _, st) in enumerate(per):
            check(st["sharded_launches"].get(key, 0) > 0,
                  f"mesh-{name}: rank {r} never launched sharded {key}")
            check(st["captures"] == 0,
                  f"mesh-{name}: rank {r} captured {st['captures']} graphs")
        cols = ("prefill_ms_median",
                "decode_ms_median" if name == "dense" else "iter_ms_median",
                "decode_tok_s", "max_memory_allocated_gb", "launches",
                "sharded_launches", "captures", "dispatch_s",
                "device_wait_s")
        print(f"serve[mesh-{name}] per rank: " + json.dumps(
            {c: [st[c] for _, _, st in per] for c in cols}))
    return ranks[0]


# ---------------------------------------------------------------------------
# Phases 10-12: the dense family at full width
# ---------------------------------------------------------------------------

# phase 10 serves ministral-3b dense then paged + speculative, phase 11
# qwen3-32b dense (the paper's other evaluation models); phase 12 runs
# the kernel path of three assigned configs against their plain path
FAMILY_SERVED = ("ministral-3b", "qwen3-32b")
FAMILY_CHECKED = ("phi4-mini-3.8b", "minicpm-2b", "chameleon-34b")
FAMILY_PROMPT = 300  # phase 12's prompt tokens
FAMILY_STEPS = 16  # phase 12's greedy decode steps


def reckon_gb(cfg) -> dict:
    """What a dense serve of ``cfg`` holds on the card before the run, GB:
    its bf16 weights and the decode instance's ring (``SLOTS`` slots of
    ``MAX_LEN`` positions, K and V of every layer)."""
    ring = (SLOTS * MAX_LEN * cfg.n_layers * 2 * cfg.n_kv_heads
            * cfg.head_dim * 2)
    return {"weights_gb": cfg.param_count() * 2 / 1e9, "ring_gb": ring / 1e9}


def family_launches(cfg, prefills: int, steps: int) -> dict:
    """The launches of ``prefills`` prompt prefills and ``steps`` decode
    steps of a dense config over the ring: one flash_prefill and one
    ring_decode per layer per call, no other kernel."""
    return {"flash_prefill": cfg.n_layers * prefills,
            "flash_prefill_q_offset": 0,
            "ring_decode": cfg.n_layers * steps, "paged": 0, "ssd_scan": 0}


def spec_kinds(r, log):
    """Which model chose each token of ``r``'s speculative stream: the
    prefill's and each verify pass's token the target, accepted drafts
    the drafter (``log``: the (rid, accepted) pairs in dispatch order)."""
    kinds = ["target"]
    for rid, a in log:
        if rid == r.rid:
            kinds += ["draft"] * a + ["target"]
    return kinds


def init_model(torch, arch):
    """``arch`` at full width and depth in bf16, random weights from a
    seeded generator; prints its shape, size and the init's peak."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models import model as M

    cfg = REGISTRY[arch]
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    if cfg.mamba is not None:
        m = cfg.mamba
        mixer = (f"d_inner {m.d_inner(cfg.d_model)}, "
                 f"{m.n_heads(cfg.d_model)} SSM heads of {m.head_dim}, "
                 f"state {m.d_state}")
        reckoned = ""
    else:
        mixer = (f"{cfg.n_heads} q heads over {cfg.n_kv_heads} kv heads of "
                 f"{cfg.head_dim} (G={cfg.n_heads // cfg.n_kv_heads})")
        reckoned = "; reckoned " + json.dumps(reckon_gb(cfg))
    extras = "".join(x for x, on in ((", tied head", cfg.tie_embeddings),
                                     (", q/k norm", cfg.qk_norm)) if on)
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{mixer}, vocab {cfg.vocab_size}{extras}, {cfg.dtype}, {n:,} "
          f"params, init {time.perf_counter() - t0:.1f} s, init peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB{reckoned}")
    return cfg, params


def family_serve_phase(torch, arch, spec: bool):
    """Phases 10 and 11: ``arch`` served as phase 4 serves llama (dense
    ring, step graphs, every launch and graph check) and one stream
    replayed through the plain path; with ``spec``, then served as
    phase 7 (paged pool, radix prefix reuse, ``SPEC_K`` drafts from the
    drafter recipe, one verify launch at T = SPEC_K + 1) with a stream
    replayed by token kind.  Frees its weights; returns the launch
    counts and stats by phase label."""
    from repro_torch.core.power import A100
    from repro_torch.models import model as M
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_draft_config

    cfg, params = init_model(torch, arch)
    label = arch.split("-")[0]
    _, _, reqs, launches, stats = serve_phase(
        torch, arch, label, {"flash_prefill": "prefill",
                             "ring_decode": "decode"}, params=params)
    replay_phase(torch, {"target": (cfg, params)}, reqs[0])
    out = {label: (launches, stats)}
    del reqs
    free(torch)
    if spec:
        t0 = time.perf_counter()
        pred = build_predictor(cfg, A100, A100.freq_levels_2, kv_cap=400_000,
                               spec_k=SPEC_K)
        print(f"{label}: predictor (decode + verify at k={SPEC_K}) fit in "
              f"{time.perf_counter() - t0:.1f} s")
        dcfg = make_draft_config(cfg)
        dparams = M.init_params(
            dcfg, torch.Generator(device="cuda").manual_seed(1),
            device="cuda")
        reqs, log, spec_launches, spec_stats = paged_serve_phase(
            torch, cfg, params, pred, drafter=(dcfg, dparams),
            label=f"{label}-spec")
        r = reqs[-1]
        kinds = spec_kinds(r, log)
        check("draft" in kinds,
              f"{label}-spec: no accepted draft token in rid {r.rid}")
        replay_phase(torch, {"target": (cfg, params),
                             "draft": (dcfg, dparams)}, r, kinds)
        out[f"{label}-spec"] = (spec_launches, spec_stats)
        del dparams, reqs, log, r
    del params
    free(torch)
    return out


def kernel_path_phase(torch, arch):
    """Phase 12 for ``arch``: one prefill of a ``FAMILY_PROMPT``-token
    prompt and ``FAMILY_STEPS`` greedy decode steps through the kernel
    path (``M.prefill``, ``M.decode_step``), with exactly one
    flash_prefill and one ring_decode launch per layer a call; then the
    same tokens teacher-forced through the plain path, each greedy token
    within ``REPLAY_MARGIN`` of its max logit.  Frees its weights;
    returns the launch counts and stats."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import _bucket

    cfg, params = init_model(torch, arch)
    label = arch.split("-")[0]
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (FAMILY_PROMPT,),
                           generator=g).tolist()
    buf = torch.zeros((1, _bucket(FAMILY_PROMPT, hi=MAX_LEN)),
                      dtype=torch.int32, device="cuda")
    buf[0, :FAMILY_PROMPT] = torch.tensor(prompt, dtype=torch.int32)
    lengths = torch.tensor([FAMILY_PROMPT], dtype=torch.int32, device="cuda")

    def counts():
        return {"flash_prefill": fops.launches,
                "flash_prefill_q_offset": fops.q_offset_launches,
                "ring_decode": dops.launches,
                "paged": sum(dops.paged_launches.values()),
                "ssd_scan": sops.launches}

    fops.launches = fops.q_offset_launches = 0
    dops.launches = 0
    dops.paged_launches.clear()
    sops.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls = {"prefill": [], "decode": []}
    logits, cache = timed(torch, M.prefill, walls["prefill"])(
        params, cfg, buf, lengths, max_len=MAX_LEN)
    after_prefill = counts()
    toks = [int(logits[0].argmax())]
    pos = lengths.clone()
    step = timed(torch, M.decode_step, walls["decode"])
    finite = bool(torch.isfinite(logits).all())
    for _ in range(FAMILY_STEPS):
        t = torch.tensor([toks[-1]], dtype=torch.int32, device="cuda")
        logits, cache = step(params, cfg, t, cache, pos)
        finite &= bool(torch.isfinite(logits).all())
        toks.append(int(logits[0].argmax()))
        pos = pos + 1
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(after_prefill == family_launches(cfg, 1, 0),
          f"{label}: the prefill launched {after_prefill}")
    check(launches == family_launches(cfg, 1, FAMILY_STEPS),
          f"{label}: launched {launches}, expected "
          f"{family_launches(cfg, 1, FAMILY_STEPS)}")
    check(finite and all(0 <= t < cfg.vocab_size for t in toks),
          f"{label}: non-finite logits or a token id out of range")
    del cache
    replay_phase(torch, {"target": (cfg, params)}, SimpleNamespace(
        rid=f"{label} (kernel path)", prompt_tokens=prompt,
        output_tokens=toks))
    check(counts() == launches, f"{label}: the plain path launched a kernel")
    stats = {"prompt": FAMILY_PROMPT, "bucket": buf.shape[1],
             "prefill_ms": walls["prefill"][0],
             "decode_ms_median": statistics.median(walls["decode"]),
             "decode_steps": FAMILY_STEPS,
             "max_memory_allocated_gb": peak / 1e9, "launches": launches}
    print(f"kernel-path[{label}]: " + json.dumps(stats))
    del params
    free(torch)
    return launches, stats


# ---------------------------------------------------------------------------


# name -> (source, the Pallas kernel it replaces, the serve phase whose
# launch count the kernels line reports)
KERNELS = {
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention/kernel.py:93",
                      "dense"),
    "ring_decode": ("src/repro_torch/kernels/csrc/ring_decode.cu",
                    "src/repro/kernels/decode_attention/kernel.py:303",
                    "dense"),
    "paged_verify": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                     "src/repro/kernels/decode_attention/kernel.py:181",
                     "spec"),
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                     "src/repro/kernels/decode_attention/kernel.py:268",
                     "paged"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd/kernel.py:98", "mamba"),
}
# the head-sharded wrappers: name -> (source, the JAX wrapper it
# replaces, the phase 9 serve whose launches the line reports, the
# kernel phase's row at one rank's shard)
WRAPPERS = {
    "decode_attention(mesh=)": (
        "src/repro_torch/kernels/decode_attention/ops.py",
        "src/repro/kernels/decode_attention/ops.py:48", "dense",
        "ring_decode@shard"),
    "paged_decode_attention(mesh=)": (
        "src/repro_torch/kernels/decode_attention/ops.py",
        "src/repro/kernels/decode_attention/ops.py:86", "paged",
        "paged_decode@shard"),
    "paged_verify_attention(mesh=)": (
        "src/repro_torch/kernels/decode_attention/ops.py",
        "src/repro/kernels/decode_attention/ops.py:122", "spec",
        "paged_verify@shard"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3 only: build, hold and time the kernels")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the port's sources (with --kernels-only)")
    args = ap.parse_args(argv)
    if args.src != SRC and not args.kernels_only:
        ap.error("--src needs --kernels-only")
    src = args.src.resolve()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
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
    for name in REDESIGNED:
        if name in built:
            print(f"ptxas[{name}]: " + json.dumps(ptxas_table(built[name][1])))
    if args.kernels_only:
        head, errs = kernel_phase(torch, F)
        lm_head_case(torch)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"src": str(src), "kernels": [
            {"name": name, "max_abs_err_by_dtype": errs[name],
             "shape": h["shape"], **timings(h)}
            for name, h in head.items()]}))
        print(json.dumps({"ok": True, "kernels_only": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    sass = sass_ops(sass_listings(_build))
    print("sass: " + json.dumps(sass))
    check(all(all(ops.values()) for ops in sass.values()),
          f"a redesigned kernel's SASS lacks a required instruction: {sass}")

    head, errs = kernel_phase(torch, F)
    lm_head_case(torch)
    dense_kernels = {"flash_prefill": "prefill", "ring_decode": "decode"}
    cfg, params, reqs, dense_launches, _ = serve_phase(
        torch, "llama-3.1-8b", "dense", dense_kernels)
    replay_phase(torch, {"target": (cfg, params)}, reqs[0])
    same_streams_eagerly(torch, reqs, "llama-3.1-8b", "dense", dense_kernels,
                         params)
    del reqs
    free(torch)  # the dense phase's ring caches

    from repro_torch.core.power import A100
    from repro_torch.models import model as M
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_draft_config

    t0 = time.perf_counter()
    pred = build_predictor(cfg, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=SPEC_K)
    print(f"predictor (decode + verify at k={SPEC_K}) fit in "
          f"{time.perf_counter() - t0:.1f} s")
    reqs, _, paged_launches, _ = paged_serve_phase(torch, cfg, params, pred)
    replay_phase(torch, {"target": (cfg, params)}, reqs[-1])

    dcfg = make_draft_config(cfg)
    dparams = M.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    reqs, log, spec_launches, _ = paged_serve_phase(
        torch, cfg, params, pred, drafter=(dcfg, dparams))
    r = reqs[-1]
    kinds = spec_kinds(r, log)
    check("draft" in kinds, f"spec: no accepted draft token in rid {r.rid}")
    replay_phase(torch, {"target": (cfg, params), "draft": (dcfg, dparams)},
                 r, kinds)
    # free the llama weights (16 GB) and the drafter before phase 8
    del params, dparams, reqs, log, r
    free(torch)

    mcfg, params, reqs, mamba_launches, _ = serve_phase(
        torch, "mamba2-2.7b", "mamba", {"ssd_scan": "prefill"})
    replay_phase(torch, {"target": (mcfg, params)}, reqs[0])
    same_streams_eagerly(torch, reqs, "mamba2-2.7b", "mamba",
                         {"ssd_scan": "prefill"}, params)
    # with the seeded init the scan's share of y lies below bf16's
    # rounding of y + D*x, so neither the replay nor the logits can see
    # the SSD path; the state can.  Then again with x/B/C rescaled to
    # order-one activations (the tests' weights), where the scan's term
    # outweighs D*x and the state reaches the logits.
    state_phase(torch, mcfg, params, reqs[0], "served", whole_path=True)
    sys.path.insert(0, str(ROOT / "tests"))
    from _mamba_weights import live_state

    state_phase(torch, mcfg, live_state(params, mcfg), reqs[0], "live",
                whole_path=False)
    del params, reqs  # free Mamba2 before phase 9
    free(torch)

    mesh = mesh_phase(torch, pred)
    # replay one stream per serve through the meshless plain path, on the
    # full weights the ranks cut their shards from
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    dparams = M.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    for name in ("dense", "paged", "spec"):
        streams, log, _ = mesh["serves"][name]
        r = SimpleNamespace(**streams[-1])
        r.rid = f"{r.rid} (mesh-{name})"
        models, kinds = {"target": (cfg, params)}, None
        if name == "spec":
            kinds = spec_kinds(SimpleNamespace(**streams[-1]), log)
            check("draft" in kinds, "mesh-spec: no accepted draft token in "
                                    f"rid {r.rid}")
            models["draft"] = (dcfg, dparams)
        replay_phase(torch, models, r, kinds)
    # free llama and the drafter before phases 10-12
    del params, dparams, models, r
    free(torch)

    family = {}
    for arch in FAMILY_SERVED:
        family.update(family_serve_phase(torch, arch,
                                         spec=arch == "ministral-3b"))
    for arch in FAMILY_CHECKED:
        family[arch.split("-")[0]] = kernel_path_phase(torch, arch)

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")

    by_phase = {"dense": dense_launches, "paged": paged_launches,
                "spec": spec_launches, "mamba": mamba_launches}
    by_phase.update({f"mesh-{name}": mesh["serves"][name][2]["launches"]
                     for name in ("dense", "paged", "spec")})
    by_phase.update({name: launches
                     for name, (launches, _) in family.items()})
    rows = []
    for name, (source, replaces, phase) in KERNELS.items():
        h = head[name]
        n = by_phase[phase][name]
        check(n > 0, f"{name} was never launched in the {phase} phase")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "launches_phase": phase,
            "launches_by_phase": {p: by_phase[p].get(name, 0)
                                  for p in by_phase},
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_dtype": errs[name], **timings(h),
        })
    hkv = 8 // MESH_TP
    for name, (source, replaces, serve, shard_row) in WRAPPERS.items():
        h = head[shard_row]
        fn = name.split("(")[0]
        kind = fn.replace("_attention", "")
        st = mesh["serves"][serve][2]
        n = st["sharded_launches"].get(f"{fn}/hkv{hkv}", 0)
        check(n > 0, f"{name} was never launched in mesh-{serve}")
        by_dtype = {d: max(e[0] for e in mesh["wrappers"][kind][d].values())
                    for d in ("bfloat16", "float32")}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "launches_phase": f"mesh-{serve} (per rank, Hkv={hkv})",
            "max_abs_err": max(by_dtype.values()),
            "max_abs_err_by_dtype": by_dtype,
            "err_against": "plain version on the full tensors",
            **timings(h),
            "timed_at": "the timings and the bound: the unsharded kernel "
                        "on one rank's shard, "
                        f"{h['shape']}",
            "wrapper_ms": mesh["wrapper_wall"][kind]["local"],
            "wrapper_ms_is": "the sharded branch as the model calls it, "
                             "rank 0, synchronised wall ms a call",
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
