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
   (HMMA, or HGMMA for wgmma), and the async copy (LDGSTS where a kernel
   stages by cp.async, UTMALDG where it loads by TMA);
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
   and speculative, as phases 4, 6 and 7, on the first ``MESH_REQUESTS``
   of phase 4's requests and ``MESH_TURNS`` turns of phase 6's.  Then, the drafter freed,
   each rank quantizes its shards on the slice (``quantize_params``
   with the mesh: each bf16 leaf freed as it goes, a row-parallel
   leaf's absmax taken over "model"), reports their checksums, and
   serves ``MESH_INT8_REQUESTS`` of phase 4's requests (those with the
   fewest decode steps) dense with an int8 ring and the first
   ``MESH_INT8_TURNS`` turn of phase 6's two conversations paged with
   int8 weights (the second reuses the first's system-prompt pages).  Both ranks must emit the same
   streams, no rank captures a graph (mesh slices run eagerly), and the
   parent replays one stream per bf16 serve and every int8 stream
   through the meshless plain path (the int8 ones on the meshless
   quantization of the same weights), and prints the int8 serves'
   iteration and peak beside the bf16 ones;
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
   within ``REPLAY_MARGIN`` of its max logit.  Each of phases 10-15
   frees its weights before the next and prints its peak memory;
13. gemma2-27b (alternating 4,096-window local and global attention,
   softcaps 50 and 30, tied 256,000-row head, 54.5 GB) at full depth,
   served dense with step graphs in ``GEMMA_SLOTS`` slots of
   ``GEMMA_MAX_LEN`` on 4 requests with prompts of 4,500-7,500 tokens:
   the window masks in every local layer's prefill and every local ring
   wraps in decode; one stream replayed through the plain path
   (``L.sliding_attention``) at the same max_len;
14. qwen3-moe-30b-a3b (128 experts, top-8, 61.1 GB) at full depth:
   phase 4's requests dense with step graphs and again eagerly (equal
   streams), then the multi-turn workload paged + speculative; a MoE
   token depends on its batch-mates through capacity drops, so every
   serve (the eager twin by its equal streams) is replayed batch for
   batch (:func:`batch_replay`: the recorded prefill, insert and step
   calls re-run through the plain path), with the dropped entries a
   decode step;
15. jamba-v0.1-52b at full width cut to one super-block (8 layers:
   7 Mamba2 + 1 attention, 4 MoE of 16 experts top-2 + 4 MLP, 26.5 GB):
   phase 4's requests dense with step graphs, seven ssd_scan and one
   flash_prefill launches a prefill and one ring_decode a step, a batch
   replay, and every Mamba2 layer's prefill state held against the plain
   path's;
16. hubert-xlarge (48 layers, 16 heads of 80, bidirectional, a GELU
   GLU MLP of 5,120: 1.26 B params, 2.52 GB) at full width and depth on
   ``HUBERT_CLIPS``: four clips of seeded frame embeddings padded to the
   longest.  ``forward`` and ``lm_logits`` through the kernel path (48
   flash_prefill launches, no other kernel) with its wall ms, its device
   time by kernel and its peak, then the plain path; every
   valid frame's class within ``REPLAY_MARGIN`` of the plain path's max
   logit; the serving factory refuses hubert (no decode phase);
17. llama-3.1-8b with int8 weights (``quantize_params`` of the bf16 init,
   which is then freed) and an int8 ring: phase 4's requests dense with
   step graphs, a stream replayed through the plain path on the same
   quantized weights and rings, and served again eagerly with the same
   streams.  The meshless tree's checksums (codes summed as int64,
   scales as float64, block by block) must equal those of phase 9's
   shards quantized on the slice, joined by each leaf's placement.
   Phase 14 also serves qwen3-moe with int8 dispatch on its weights,
   replayed batch for batch;
18. minicpm-2b at full width and depth trained in bf16 on
   ``launch/train.py``'s synthetic batch (B=4, S=1,024, remat, CE chunks
   of 512): step 1's loss against the plain path and every gradient leaf
   against the plain path on float32 weights, then ``TRAIN_STEPS`` WSD
   steps with exact flash_prefill / flash_backward launches and a loss
   that falls, the median step, tokens/s, peak and one step's device
   time by kernel group, and a checkpoint round trip at reduced size
   that repeats a step bit for bit;
19. mamba2-2.7b at full width and depth (64 layers, 80 SSM heads of 64,
   state 128, 2.70 B params) trained as phase 18: every Mamba2 layer's
   gradient through ``ssd_backward`` (the forward writing the state
   entering each 64-row sub-chunk), 128 ssd_scan and 64 ssd_backward
   launches a step and no attention kernel; no checkpoint round trip;
20. (run right after phase 9, before phase 10) a world of
   ``DISJOINT_WORLD`` = 2 ranks on the card, each holding llama-3.1-8b
   at full width and depth: the prefill instance a tp=1 slice on rank 0,
   the decode instance one on rank 1, eager, so every P→D handoff
   crosses ranks (staged through pinned host memory under gloo).  Phase
   4's requests over the dense ring must give each rank phase 4's eager
   streams and the same virtual-clock finish times and energy, each
   handoff moving the whole B=1 ring; phase 6's multi-turn workload over
   the paged pool (radix reuse) must give both ranks the same streams,
   drained pools, and a stream that replays on the full weights.  It
   prints each crossing handoff's bytes and wall ms beside the bytes the
   virtual clock prices, and each rank's walls and peak;
21. (run right after phase 20) a world of ``MIXER_TP`` = 2 ranks on the
   card, one tp=2 slice for both instances, eager: in turn, each rank
   draws its shards on the slice (``init_params(mesh=)``, seed 0),
   serves, then frees (a) mamba2-2.7b at full width and depth (40 of its
   80 SSD heads a rank) dense on the first ``MIXER_REQUESTS`` of phase 4's
   requests, (b) qwen3-moe-30b-a3b at full width and depth (64 of 128
   experts, 16/2 of 32/4 heads a rank) dense on those requests and paged
   on the first ``MIXER_TURNS`` turns of phase 6's multi-turn workload
   (the JAX package's sharded-MoE acceptance scenario), (c)
   jamba-v0.1-52b cut to one super-block (SSD heads, attention heads and
   experts all split) dense on those requests.  After the collective
   probe, qwen3-moe serves ``MIXER_INT8_REQUESTS`` of phase 4's
   requests (the fewest decode steps) with int8 dispatch on its bf16 shards (the gather moves
   int8 codes and row scales; probed again, its bytes a layer beside
   the bf16 gather's), and mamba2's shards, quantized on the slice
   (``in_proj``'s scales cut by segment, ``conv_w``'s and
   ``out_proj``'s taken over "model"), serve those requests with int8
   weights.  Both ranks must emit the
   same streams of ``decode_len + 1`` tokens, hold the rules' local
   parameter counts, launch ssd_scan and flash_prefill at their share of
   the heads only (and the decode wrapper's sharded branch at their kv
   heads), and drain their pools; every stream replays batch for batch
   through the meshless plain path on the full weights from the same
   seed, each MoE layer forced to the slice's own routings within
   ``ROUTE_MARGIN``.  It prints each rank's walls, peaks and the
   collectives of one prefill and one decode step (calls, bytes, the
   MoE gather's ms a layer).

22. (run right after phase 3, on an empty card) the dry-run against the
   card: ``launch/dryrun.py``'s tracer runs a step on meta tensors (no
   kernel built or called), then the same step runs on the card under
   the same counters: llama-3.1-8b's decode step at ``SLOTS`` slots of
   ``MAX_LEN`` and its ``DRYRUN_PROMPT``-token prefill (the weights then
   serve phase 4), and minicpm-2b's train step (B=4 x 1,024, remat).
   Launch counts and FLOPs must be equal, resident bytes before the step
   within ``RESIDENT_TOL``, the step's transient peak
   (``max_memory_allocated`` after ``reset_peak_memory_stats``) within
   ``PEAK_TOL`` or ``PEAK_SLACK``; the predicted time bound prints beside
   the step's device busy ms (profiler) and wall ms, unchecked;
23. (after phase 22) ``examples/train_small_torch.py``'s demo-8m
   (float32, head dim 32) for ``DEMO_STEPS`` steps through the Dh 32
   float32 flash kernels: step 1's loss and gradients against the plain
   path, exact launches, a falling loss, and a resume from the
   checkpoint that gives the state in memory's next loss.

The kernel phase holds flash_prefill at head dim 80 without the causal
mask (hubert's) in both dtypes and times it at hubert's shape beside
SDPA on the same key mask, and at minicpm's training shape writing its
log-sum-exp (phase 18's forward) beside SDPA's forward; it holds
flash_backward (dq, dk, dv) against the plain backward at minicpm's
training shape, llama's GQA, gemma2's window and softcap and hubert's
head dim 80, in both dtypes, each call repeated bit for bit, timed in
bf16 beside SDPA's backward, each row naming the body it ran and that
body's ``ptxas -v`` rows.  It holds ssd_scan at mamba2-2.7b's training
shape writing its sub-chunk states (held against the plain recurrence's)
and ssd_backward (dx, ddt, dA, dB, dC) against the plain backward at the
SSD sweep's shapes and the training shape, with and without a final-state
cotangent, in both dtypes, each call repeated bit for bit and the last
batch rows alone equal to the batch; both timed in bf16 at the training
shape; ssd_scan at one rank's SSD heads of mamba2 at tp=2 (H = 40,
phase 21); and flash_prefill (its training forward) and flash_backward
in float32 at head dim 32, demo-8m's shape (phase 23), timed beside
SDPA.  Where SDPA has no softcap (gemma2's prefill, its backward
row and its rings), the library yardstick is ``flex_attention``
compiled with a tanh softcap ``score_mod`` and the case's block mask,
timed by both methods.

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
# the SSD backward against autograd through the float32 plain scan, each
# gradient relative to its largest magnitude.  Both compute in float32;
# dA sums B * S terms (4,096 at mamba2's training shape) in another
# order, and bf16 rounds dx, dB and dC once on output (2^-9)
SSD_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
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
# A MoE router's near-tie, in router-logit units (:class:`Routes`).  The
# kernel path and the plain path round the residual stream differently,
# so router logits move by hundredths between them and the k-th and
# (k+1)-th experts swap where they were that close: on an H100, 61 of
# jamba's 9,824 routed rows in phase 15, one of which moved an emitted
# token's logit by 0.556, and 5.8% of qwen3-moe's rows (top-8 of 128) in
# phase 14; the served expert then lay at most 0.055 below the plain
# top-k.  Neighbouring order statistics of 16 or 128 router logits of
# spread about 1 lie tenths apart; a wrong routing misses by more.
ROUTE_MARGIN = 0.1
MAX_LEN = 1024
SLOTS = 8
L2_BYTES = 50e6
SLEEP_CYCLES = 100_000_000  # about 50 ms of SM clock: queued_ms's head start
SPEC_K = 2  # draft proposals per verify pass: T = SPEC_K + 1
PAGE_SIZE = 16
PMAX = MAX_LEN // PAGE_SIZE
POOL_PAGES = (2 * SLOTS + 8) * PMAX  # the backend's default pool
MESH_TP = 2  # phase 9: ranks of the world, each instance's slice width
# gloo stages phase 9's collectives through the host, so its iterations
# take 150-720 ms and the phase's wall varies 2x between calls: it serves
# fewer requests than phases 4, 6 and 7, at full depth
MESH_REQUESTS = 4  # the first of phase 4's requests, the bf16 dense serve
MESH_TURNS = 2  # of phase 6's multi-turn workload, bf16 paged and spec
# phase 9's int8 serves, after its bf16 ones: requests cut, never depth
MESH_INT8_REQUESTS = 3  # of phase 4's requests (the shortest), dense
MESH_INT8_TURNS = 1  # of phase 6's multi-turn workload (2 requests), paged
MESH_SERVES = ("dense", "paged", "spec", "int8-dense", "int8-paged")
# phase 13: gemma2-27b past its window, 4 slots of 8,192 + 64 positions
GEMMA_WINDOW = 4096
GEMMA_BUCKET = 8192
GEMMA_MAX_LEN = GEMMA_BUCKET + 64
GEMMA_SLOTS = 4
MESH_TIMEOUT_S = 600.0  # the parent's wait for the phase 9 world
# phase 16: hubert-xlarge on four clips of frame embeddings, 20 ms a
# frame (8-30 s of 16 kHz audio), padded to the longest
HUBERT_CLIPS = (400, 750, 1100, 1500)
HUBERT_FRAMES = max(HUBERT_CLIPS)
# the flash backward against the plain backward (autograd through the
# float32 reference), each gradient relative to its largest magnitude:
# the bf16 kernel rounds P and dS to bf16 for its tensor-core products
BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# phase 18: minicpm-2b trained at full width and depth on the synthetic
# batch of launch/train.py, remat on, the CE over 512-token chunks
TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_CE_CHUNK = 512
TRAIN_STEPS = 5
# step 1 through the kernels against the plain path on the same weights:
# the loss within TRAIN_LOSS_TOL relative.  Each leaf's gradient is held
# against the plain path run on a float32 copy of the weights: its
# relative L2 error must stay within TRAIN_GRAD_TOL or within
# TRAIN_GRAD_RATIO times the bf16 plain path's own error against that
# float32 gradient.  The bf16 model is the limit, not the kernel: on an
# H100 the two bf16 paths lie 2.5-6.3% apart at 40 layers, every kind of
# leaf alike, and each lies about as far from the float32 gradient
# (PERF.md)
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2
TRAIN_GRAD_RATIO = 1.25
# phase 19: mamba2-2.7b trained at full width and depth as phase 18
# trains minicpm-2b (the same batch, remat, CE chunks, steps and limits)
MAMBA_TRAIN_ARCH = "mamba2-2.7b"


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

# what the SASS of each library must show: for the kernels rebuilt on
# the tensor cores the tensor-core product (HMMA for mma.sync, HGMMA for
# wgmma), the async copy (LDGSTS for cp.async, UTMALDG for a TMA tensor
# load), ldmatrix (LDSM).  flash_backward's bf16 body at Dh 64 and 128 is
# wgmma + TMA; at Dh 16 and 80 it keeps mma.sync (HMMA).  ssd_backward's
# bf16 body (walk and sub-chunks) runs on mma.sync, staged by cp.async
# (and the state tiles by bulk copies)
REDESIGNED = {
    "flash_prefill": ("HMMA", "LDGSTS", "LDSM"),
    "flash_backward": ("HGMMA", "UTMALDG", "HMMA"),
    "paged_attention": ("HMMA", "LDGSTS", "LDSM"),
    "ring_decode": ("HMMA", "LDGSTS", "LDSM"),
    "ssd_scan": ("HMMA", "LDGSTS", "LDSM"),
    "ssd_backward": ("HMMA", "LDGSTS", "LDSM"),
}
# what the SASS of a library must not show: the backward kernels add in
# a fixed order, with no atomic (ATOM global or shared, RED)
FORBIDDEN = {"ssd_backward": ("ATOM", " RED.")}


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


# ``ptxas -v`` of the libraries this run built, by library ({kernel
# instantiation: registers, smem, spills}); the backward rows quote the
# entries of the body they ran
PTXAS = {}
# the kernels of each flash_backward body
BODY_KERNELS = {"wgmma": ("dkdvq_wgmma_kernel",),
                "mma_sync": ("dkdv_bf16_kernel", "dq_bf16_kernel"),
                "cuda_cores": ("dkdv_f32_kernel", "dq_f32_kernel")}


def body_ptxas(body: str, Dh: int):
    """The ``ptxas -v`` rows of a flash_backward body at head dim ``Dh``
    (None where this run did not build the library)."""
    table = PTXAS.get("flash_backward")
    if table is None:
        return None
    return {k: table[k] for k in (f"{n}<{Dh}>" for n in BODY_KERNELS[body])
            if k in table}


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
    listing shows each instruction ``REDESIGNED`` requires of it, and
    ``{"no " + op: absent}`` for each one ``FORBIDDEN`` rules out."""
    return {name: {**{op: op in listings[name] for op in ops},
                   **{f"no {op.strip()}": op not in listings[name]
                      for op in FORBIDDEN.get(name, ())}}
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


def flex_library(torch, mask_mod, softcap, B, q_len, kv_len):
    """The library yardstick of a softcapped attention case (never called
    by the port): ``flex_attention`` compiled by ``torch.compile``, with
    the tanh softcap as its ``score_mod`` and ``mask_mod`` as its block
    mask, on head-major (B, H, S, D) inputs with grouped kv heads."""
    from torch.nn.attention.flex_attention import (
        create_block_mask, flex_attention,
    )

    block = create_block_mask(mask_mod, B, None, q_len, kv_len,
                              device="cuda")

    def capped(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    compiled = torch.compile(flex_attention, dynamic=False)

    def call(q, k, v):
        return compiled(q, k, v, score_mod=capped, block_mask=block,
                        enable_gqa=True)
    return call


def flex_timings(torch, lib, sets, want, dtype: str):
    """``library_ms`` (paced) and ``library_device_ms`` of ``lib`` over
    ``sets``, after holding its first output against ``want`` (the plain
    version's); where flex_attention fails to compile or run at the
    shape, no times and the reason in ``library_note``."""
    try:
        got = lib(*sets[0])
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        ms = cuda_ms(torch, lib, sets)
        dev_ms, _ = queued_ms(torch, lib, sets)
    except Exception as e:  # reported in the row, not a failed phase
        return {"library_ms": None, "library_device_ms": None,
                "library_note": f"flex_attention failed: {type(e).__name__}"
                                f": {str(e)[:300]}"}
    return {"library_ms": ms, "library_device_ms": dev_ms,
            "library": "flex_attention (torch.compile), tanh softcap "
                       "score_mod, block mask",
            "library_max_abs_err": err}


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
               timed: bool, q_start=None, causal=True, kv_lens=None,
               train_lse: bool = False):
    """One prefill case.  With ``q_start`` (the paged prefill after a
    prefix hit) the keys are the gathered view of a full table
    (``MAX_LEN`` positions), query row i sits at ``q_start + i`` and
    ``kv_len = q_start + S * kv_frac``.  ``kv_lens`` gives each batch
    row its own ``kv_len`` (padded clips of an encoder); ``causal=False``
    drops the causal mask.  ``train_lse``: the training forward, which
    also writes each row's log-sum-exp (no kv_len or q_start)."""
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
    if kv_lens is not None:
        kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    elif kv_frac is not None:
        kv_len = torch.full((B,), qs + max(1, int(S * kv_frac)),
                            dtype=torch.int32, device="cuda")
    if q_start is not None:
        qst = torch.full((B,), q_start, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
              q_start=qst)
    if train_lse:
        check(kv_len is None and qst is None,
              "the training forward takes no kv_len or q_start")
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")

    def kernel(a, b, c):
        if train_lse:
            return fops._launch(a, b, c, causal, window, softcap, None, None,
                                lse)
        return fops.flash_attention(a, b, c, **kw)
    got = kernel(q, k, v)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, dtype)
    check(ok, f"flash_prefill disagrees with its plain version at S={S} "
              f"Dh={Dh} {dtype} causal={causal} kv_len="
              f"{kv_frac if kv_lens is None else kv_lens} window={window} "
              f"softcap={softcap} q_start={q_start}: max abs err {err}")
    lens = [Skv] * B if kv_len is None else kv_len.tolist()
    row = {"shape": f"B={B} S={S} Skv={Skv} Hq={Hq} Hkv={Hkv} Dh={Dh}",
           "dtype": dtype, "causal": causal, "q_start": q_start,
           "kv_len": None if kv_len is None else (
               lens if kv_lens is not None else lens[0]),
           "window": window, "softcap": softcap, "max_abs_err": err,
           **({"writes_lse": True} if train_lse else {})}
    if not timed:
        return row
    # work this data needs (the wrapper's cost function): (q, key) pairs
    # that are unmasked, each row's valid keys
    esz = q.element_size()
    flops, nbytes = fops.flash_cost(B, S, Skv, Hq, Hkv, Dh, esz,
                                    causal=causal, window=window,
                                    q_start=qs, lens=lens)
    sets = copies(torch, (q, k, v), (q.numel() + 2 * k.numel()) * esz)
    ms = cuda_ms(torch, kernel, sets)
    # the plain version materialises (Hq, S, Skv) float32 scores
    plain_ms = cuda_ms(torch, lambda a, b, c: attention_ref(a, b, c, **kw),
                       sets, iters=5 if B * S * Skv > 2 ** 24 else 20)
    dev_ms, host_ms = queued_ms(torch, kernel, sets)
    lib_ms = lib_dev_ms = None
    if softcap is None:
        # library yardstick (never called by the port): SDPA on the same
        # inputs (head-major views) with the same mask; SDPA has no
        # softcap, so a softcapped case has none
        qp = (qs + torch.arange(S, device="cuda"))[:, None]
        j = torch.arange(Skv, device="cuda")[None, :]
        Lb = torch.tensor(lens, device="cuda")[:, None, None]
        mask = j[None] < Lb  # (B, 1 or S, Skv)
        if causal:
            mask = mask & (qp >= j)[None]
        if window is not None:
            mask = mask & (qp - j < window)[None]
        mask = mask[:, None]

        def lib(a, b, c):
            return F.scaled_dot_product_attention(
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        lib_ms = cuda_ms(torch, lib, sets)
        lib_dev_ms, _ = queued_ms(torch, lib, sets)
    else:
        # SDPA has no softcap: flex_attention with the same mask
        L_ = torch.tensor(lens, device="cuda")

        def allowed(b, h, q_idx, kv_idx):
            qpos = q_idx + qs
            ok = (kv_idx < L_[b]) & (qpos >= kv_idx if causal else
                                     kv_idx >= 0)
            return ok & (qpos - kv_idx < window) if window is not None \
                else ok
        flex = flex_library(torch, allowed, softcap, B, S, Skv)

        def lib(a, b, c):
            return (flex(a.transpose(1, 2), b.transpose(1, 2),
                         c.transpose(1, 2)).transpose(1, 2),)
        flexed = flex_timings(torch, lib, sets, (want,), dtype)
        lib_ms, lib_dev_ms = flexed.pop("library_ms"), flexed.pop(
            "library_device_ms")
        row.update(flexed)
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=lib_dev_ms, flops=flops, bytes=nbytes)
    row.update(ratios(row))
    return row


def flash_backward_case(torch, F, B, S, Hq, Hkv, Dh, dtype, causal, window,
                        softcap, timed: bool):
    """One backward case: the training forward (``flash_prefill`` with its
    row log-sum-exp), then dq, dk and dv from ``flash_backward`` against
    autograd through the float32 plain version on the same inputs, each
    relative to its largest magnitude (``BWD_TOL``), and a second call
    that must repeat the first bit for bit.  Timed: the kernel call, the
    plain backward and, where SDPA computes the same function (no softcap
    and no window), SDPA's backward alone (its forward's graph kept)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_backward_ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S * 7 + Dh + Hq)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
               for shape in ((B, S, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    dout = torch.randn((B, S, Hq, Dh), generator=g, device="cuda").to(dt)
    mask = dict(causal=causal, window=window, softcap=softcap)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")
    out = fops._launch(q, k, v, causal, window, softcap, None, None, lse)
    got = fops.flash_backward(q, k, v, out, dout, lse, **mask)
    again = fops.flash_backward(q, k, v, out, dout, lse, **mask)
    want = attention_backward_ref(q, k, v, dout, **mask)
    torch.cuda.synchronize()
    label = (f"flash_backward at B={B} S={S} Hq={Hq} Hkv={Hkv} Dh={Dh} "
             f"{dtype} causal={causal} window={window} softcap={softcap}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label}: two calls differ")
    errs, rel = [], []
    for a, b in zip(got, want):
        e = float((a.float() - b).abs().max())
        errs.append(e)
        rel.append(e / float(b.abs().max()))
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite values")
    check(max(rel) <= BWD_TOL[dtype],
          f"{label} disagrees with the plain backward: errors relative to "
          f"each gradient's max (dq, dk, dv) {rel}")
    # (an older checkout under --src names no bodies)
    body = getattr(fops, "backward_body", lambda *a: None)(
        1 if dtype == "bfloat16" else 0, Dh)
    # the wgmma body's items per (b, kv head, key tile) on this card
    split = (fops.backward_split(S, S, Hq, Hkv, Dh, causal, window, 1)
             if body == "wgmma" else None)
    row = {"shape": f"B={B} S={S} Hq={Hq} Hkv={Hkv} Dh={Dh}", "dtype": dtype,
           "causal": causal, "window": window, "softcap": softcap,
           "max_abs_err": max(errs), "rel_err_dq_dk_dv": rel,
           "repeats_bitwise": True, "body": body, "split": split,
           "ptxas": body_ptxas(body, Dh) if body else None}
    if not timed:
        return row
    # the work of the function (the wrapper's cost function): per valid
    # (query, key) pair and q head 10 Dh; q, k, v, out, dout and lse read
    # once, dq, dk, dv written once
    esz = q.element_size()
    flops, nbytes = fops.flash_backward_cost(B, S, S, Hq, Hkv, Dh, esz,
                                             causal=causal, window=window)
    sets = copies(torch, (q, k, v, out, dout, lse), nbytes)

    def kernel(a, b, c, o, d, ls):
        return fops.flash_backward(a, b, c, o, d, ls, **mask)

    def plain(a, b, c, o, d, ls):
        return attention_backward_ref(a, b, c, d, **mask)

    ms = cuda_ms(torch, kernel, sets)
    plain_ms = cuda_ms(torch, plain, sets, iters=5)
    dev_ms, host_ms = queued_ms(torch, kernel, sets)
    lib_ms = lib_dev_ms = None
    if softcap is None and window is None:
        # library yardstick (never called by the port): SDPA's backward
        # on the same inputs, head-major, its forward's graph kept
        graphs = []
        for a, b, c, o, d, ls in sets:
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (a, b, c)]
            res = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=Hq != Hkv)
            graphs.append((res, leaves, d.transpose(1, 2)))

        def lib(res, leaves, d):
            return torch.autograd.grad(res, leaves, d, retain_graph=True)
        lib_sets = [tuple(x) for x in graphs]
        lib_ms = cuda_ms(torch, lib, lib_sets)
        lib_dev_ms, _ = queued_ms(torch, lib, lib_sets)
        del graphs, lib_sets
    elif softcap is not None:
        # SDPA has no softcap: flex_attention's backward, its compiled
        # forward's graph kept
        def allowed(b, h, q_idx, kv_idx):
            ok = q_idx >= kv_idx if causal else kv_idx >= 0
            return ok & (q_idx - kv_idx < window) if window is not None \
                else ok
        flex = flex_library(torch, allowed, softcap, None, S, S)
        graphs = []
        for a, b, c, o, d, ls in sets:
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (a, b, c)]
            graphs.append((flex(*leaves), leaves, d.transpose(1, 2)))

        def lib(res, leaves, d):
            return [t.transpose(1, 2) for t in torch.autograd.grad(
                res, leaves, d, retain_graph=True)]
        flexed = flex_timings(torch, lib, [tuple(x) for x in graphs], want,
                              dtype)
        lib_ms, lib_dev_ms = flexed.pop("library_ms"), flexed.pop(
            "library_device_ms")
        row.update(flexed)
        del graphs
    else:
        row["library_note"] = "SDPA has no window: no library call"
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=lib_dev_ms, flops=flops, bytes=nbytes)
    row.update(ratios(row))
    return row


def decode_case(torch, F, B, C, Hq, Hkv, Dh, dtype, window, softcap,
                timed: bool, written=None):
    """One ring decode case: partly filled rows and a last row all empty
    (a free decode slot); with ``written`` (a length per row), rows whose
    ring has taken that many positions, position p at slot p % C, so a
    row past C has wrapped (no empty row then)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(C * 7 + Dh)
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dt)
    kc = torch.randn((B, C, Hkv, Dh), generator=g, device="cuda").to(dt)
    vc = torch.randn((B, C, Hkv, Dh), generator=g, device="cuda").to(dt)
    slots = torch.arange(C, device="cuda")
    if written is None:
        filled = torch.randint(C // 4, C, (B,), generator=g, device="cuda")
        filled[-1] = 0
        slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                               -1).to(torch.int32)
    else:  # the latest position p < n with p % C == s, or -1
        filled = torch.tensor(written, device="cuda")
        last = slots[None] + C * torch.div(filled[:, None] - 1 - slots[None],
                                           C, rounding_mode="floor")
        slot_pos = torch.where(last >= 0, last, -1).to(torch.int32)
    q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
    kw = dict(window=window, softcap=softcap)
    got = dops.decode_attention(q, kc, vc, slot_pos, q_pos, **kw)
    want = decode_attention_ref(q, kc, vc, slot_pos, q_pos, **kw)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, dtype)
    check(ok, f"ring_decode disagrees with its plain version at B={B} C={C} "
              f"{dtype} window={window} softcap={softcap} written="
              f"{written}: max abs err {err}")
    row = {"shape": f"B={B} C={C} Hq={Hq} Hkv={Hkv} Dh={Dh}", "dtype": dtype,
           "window": window, "softcap": softcap, "written": written,
           "max_abs_err": err}
    if written is None:
        empty_mean = vc[-1].float().mean(dim=0)  # (Hkv, Dh)
        G = Hq // Hkv
        want_empty = empty_mean.repeat_interleave(G, dim=0).to(dt).float()
        empty_err = float((got[-1].float() - want_empty).abs().max())
        check(empty_err <= TOL[dtype] * (1 + float(want_empty.abs().max())),
              f"ring_decode all-empty row is not the mean of V: {empty_err}")
        row["empty_row_err"] = empty_err
    if not timed:
        return row
    # bytes this data needs: unmasked slots' K and V, all of V for an
    # empty row (its mean), slot positions, q and out
    live = (slot_pos >= 0) & (slot_pos <= q_pos[:, None])
    if window is not None:
        live &= q_pos[:, None] - slot_pos < window
    valid = int(live.sum())
    empty = int((live.sum(dim=1) == 0).sum())
    esz = q.element_size()
    flops, nbytes = dops.ring_decode_cost(B, C, Hq, Hkv, Dh, esz,
                                          valid=valid, empty=empty)
    sets = copies(torch, (q, kc, vc), (q.numel() + 2 * kc.numel()) * esz)
    ms = cuda_ms(torch, lambda a, b, c: dops.decode_attention(
        a, b, c, slot_pos, q_pos, **kw), sets)
    plain_ms = cuda_ms(torch, lambda a, b, c: decode_attention_ref(
        a, b, c, slot_pos, q_pos, **kw), sets)
    dev_ms, host_ms = queued_ms(torch, lambda a, b, c: dops.decode_attention(
        a, b, c, slot_pos, q_pos, **kw), sets)
    by_kernel = device_ms_by_kernel(torch, lambda: dops.decode_attention(
        q, kc, vc, slot_pos, q_pos, **kw))
    lib_ms = lib_dev_ms = None
    if softcap is None:
        mask = live[:, None, None]

        def lib(a, b, c):
            return F.scaled_dot_product_attention(
                a[:, :, None], b.transpose(1, 2), c.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        lib_ms = cuda_ms(torch, lib, sets)
        lib_dev_ms, _ = queued_ms(torch, lib, sets)
    else:
        # SDPA has no softcap: flex_attention over one query a row
        flex = flex_library(torch, lambda b, h, q_idx, kv_idx: live[b, kv_idx],
                            softcap, B, 1, C)

        def lib(a, b, c):
            return (flex(a[:, :, None], b.transpose(1, 2),
                         c.transpose(1, 2))[:, :, 0],)
        flexed = flex_timings(torch, lib, sets, (want,), dtype)
        lib_ms, lib_dev_ms = flexed.pop("library_ms"), flexed.pop(
            "library_device_ms")
        row.update(flexed)
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
    flops, nbytes = dops.paged_cost(B, T, Hq, Hkv, Dh, esz, bt.numel(),
                                    lengths, window)
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


def plain_sub_chunk_states(torch, x, dt, A, Bm, Cm):
    """The plain recurrence's state entering each of the kernels' 64-row
    sub-chunks, (B, n_sub, H, P, N) float32: what the training forward
    writes for the backward."""
    from repro_torch.kernels.ssd.ops import SUB_CHUNK
    from repro_torch.kernels.ssd.ref import ssd_decode_step

    B, S, H, P = x.shape
    state = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    out = []
    for t in range(S):
        if t % SUB_CHUNK == 0:
            out.append(state)
        _, state = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   state)
    return torch.stack(out, dim=1)


def ssd_case(torch, B, S, H, P, N, chunk, dtype, timed: bool, length=None,
             fused=False, law=False, train_states=False):
    """One SSD scan case.  ``length``: x = dt = 0 past it (the model's
    pad tail), so the final state must be the one after ``length``
    tokens.  ``fused``: x, B and C are slices of one (B, S, conv_dim)
    tensor, as the model passes them (only such a case is timed).
    ``law``: dt and A under the model's law (``model_law``), whose long
    memory carries across every sub-chunk and chunk; otherwise dt is
    about 0.7 and A about -1, a memory of about 2 tokens.
    ``train_states``: the training forward, which also writes the state
    entering each sub-chunk (held against the plain recurrence's; timed
    so)."""
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
    states = None
    if train_states:
        states = torch.empty(sops.states_shape(B, S, H, P, N),
                             dtype=torch.float32, device="cuda")
        y, st = sops._launch(x, dt, A, Bm, Cm, states)
    else:
        y, st = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yr, sr = ssd_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    errs, scaled = [], []
    pairs = [(y, yr), (st, sr)]
    if train_states:
        pairs.append((states, plain_sub_chunk_states(torch, x, dt, A, Bm,
                                                     Cm)))
    for got, want in pairs:
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
    if train_states:
        row.update(writes_states=True, scaled_err_states=scaled[2],
                   states_gb=states.numel() * 4 / 1e9)
    if not timed:
        return row
    # bytes: x, dt, A, B, C read once, y and the state written once;
    # operations: per chunk of L rows the causal half of C.B (shared by
    # the heads), and per head the intra-chunk, inter-chunk and state
    # products
    esz = x.element_size()
    flops, nbytes = sops.ssd_scan_cost(B, S, H, P, N, chunk, esz,
                                       train_states)
    sets = copies(torch, (xbc, dt), xbc.numel() * esz + dt.numel() * 4)

    def on_views(fn):
        def call(xbc_, dt_):
            x_, b_, c_ = split(xbc_)
            return fn(x_, dt_, A, b_, c_)
        return call

    call = (partial(sops._launch, states=states) if train_states
            else partial(sops.ssd_scan, chunk=chunk))
    ms = cuda_ms(torch, on_views(call), sets)
    plain_ms = cuda_ms(torch, on_views(ssd_ref), sets, iters=5)
    dev_ms, host_ms = queued_ms(torch, on_views(call), sets)
    by_kernel = device_ms_by_kernel(torch, lambda: call(x, dt, A, Bm, Cm))
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=None, bytes=nbytes, flops=flops,
               library_note="no single PyTorch call computes the SSD scan",
               device_ms_by_kernel=by_kernel)
    row.update(ratios(row))
    return row


def ssd_backward_scratch_bytes(sops, B, S, H, P, N, code: int) -> int:
    """The design's own traffic beside the function's bytes: the
    forward's states read once, the walk's dS written and read, and the
    partial sums of dB and dC written and read (the scratch shapes the
    wrapper allocates)."""
    try:
        shapes = sops.backward_scratch_shapes(B, S, H, P, N, code)
    except TypeError:  # an older tree (--src): per-head partials
        shapes = sops.backward_scratch_shapes(B, S, H, P, N)
    states, dbp, dcp, dap = (math.prod(s) for s in shapes)
    return 4 * (states + 2 * states + 2 * dbp + 2 * dcp + 2 * dap)


def ssd_backward_case(torch, B, S, H, P, N, dtype, dstate: bool,
                      timed: bool, fused=False):
    """One SSD backward case: the training forward (``ssd_scan`` writing
    the state entering each sub-chunk), then (dx, ddt, dA, dB, dC) from
    ``ssd_backward`` against autograd through the float32 plain scan on
    the same inputs (``ssd_backward_ref``), each relative to its largest
    magnitude (``SSD_BWD_TOL``), with a cotangent on the final state when
    ``dstate``; a second call must repeat the first bit for bit, and for
    B > 1 the last rows alone must equal theirs in the batch (dA, a sum
    over the batch, aside).  ``fused``: x, B and C are slices of one
    (B, S, conv_dim) tensor, as the model passes them.  Timed: the kernel
    call and the plain backward."""
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import ssd_backward_ref

    dt_ = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S * 13 + H + N + dstate)
    di = H * P
    def split(t):
        return (t[..., :di].reshape(B, S, H, P), t[..., di: di + N],
                t[..., di + N:])

    if fused:
        xbc = torch.randn((B, S, di + 2 * N), generator=g, device="cuda")
        xbc[..., di:] *= 0.3
        xbc = xbc.to(dt_)
        x, Bm, Cm = split(xbc)
    else:
        x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dt_)
        Bm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(dt_)
        Cm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    dy = torch.randn((B, S, H, P), generator=g, device="cuda").to(dt_)
    ds = (torch.randn((B, H, P, N), generator=g, device="cuda") if dstate
          else None)
    states = torch.empty(sops.states_shape(B, S, H, P, N),
                         dtype=torch.float32, device="cuda")
    sops._launch(x, dt, A, Bm, Cm, states)
    got = sops.ssd_backward(x, dt, A, Bm, Cm, dy, states, ds)
    again = sops.ssd_backward(x, dt, A, Bm, Cm, dy, states, ds)
    want = ssd_backward_ref(x, dt, A, Bm, Cm, dy, ds)
    torch.cuda.synchronize()
    label = (f"ssd_backward at B={B} S={S} H={H} P={P} N={N} {dtype} "
             f"dstate={dstate} fused={fused}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label}: two calls differ")
    alone = None
    if B > 1:
        one = sops.ssd_backward(
            x[1:], dt[1:], A, Bm[1:], Cm[1:], dy[1:], states[1:],
            None if ds is None else ds[1:])
        alone = all(torch.equal(a, b[1:]) for i, (a, b) in
                    enumerate(zip(one, got)) if i != 2)
        check(alone, f"{label}: the last rows alone differ from the batch")
    errs, rel = [], []
    for a, b in zip(got, want):
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite values")
        e = float((a.float() - b).abs().max())
        errs.append(e)
        rel.append(e / (float(b.abs().max()) + 1e-30))
    check(max(rel) <= SSD_BWD_TOL[dtype],
          f"{label} disagrees with the plain backward: errors relative to "
          f"each gradient's max (dx, ddt, dA, dB, dC) {rel}")
    row = {"shape": f"B={B} S={S} H={H} P={P} N={N}", "dtype": dtype,
           "dstate": dstate, "fused": fused, "max_abs_err": max(errs),
           "rel_err_dx_ddt_dA_dB_dC": rel, "repeats_bitwise": True,
           "row_alone_equals_batch": alone,
           "ptxas": {k: v for k, v in PTXAS.get("ssd_backward", {}).items()
                     if k.endswith(f"<{N}>")
                     and ("_tc_" in k) == (dtype == "bfloat16")
                     or k.startswith("ssd_bwd_sum")} or None}
    if not timed:
        return row
    # bytes: the function's inputs x, dt, A, B, C, dy (and dstate) read
    # once and dx, ddt, dA, dB, dC written once (the forward's states and
    # the scratch are the design's own traffic, ``scratch_bytes``, not
    # counted); operations: per (b, h) and 64-row sub-chunk of
    # T = 64 * 65 / 2 causal pairs, dy.x^T, the
    # intra-chunk dx, dB and dC (T P, T P, 2 T N) and the state terms of
    # dx, dB, dC and the state gradient's walk (4 L N P); C.B^T (T N) once
    # per (b, sub-chunk), shared by the heads
    esz = x.element_size()
    flops, nbytes = sops.ssd_backward_cost(B, S, H, P, N, esz, dstate)
    sets = copies(torch, (xbc if fused else x, dt, dy, states), nbytes)

    def on_views(fn):
        def call(s_, dt__, dy_, st_):
            if fused:
                x_, b_, c_ = split(s_)
            else:
                x_, b_, c_ = s_, Bm, Cm
            return fn(x_, dt__, A, b_, c_, dy_, st_)
        return call

    def kernel(x_, dt__, A_, b_, c_, dy_, st_):
        return sops.ssd_backward(x_, dt__, A_, b_, c_, dy_, st_, ds)

    def plain(x_, dt__, A_, b_, c_, dy_, st_):
        return ssd_backward_ref(x_, dt__, A_, b_, c_, dy_, ds)

    ms = cuda_ms(torch, on_views(kernel), sets)
    plain_ms = cuda_ms(torch, on_views(plain), sets, iters=2)
    dev_ms, host_ms = queued_ms(torch, on_views(kernel), sets)
    by_kernel = device_ms_by_kernel(
        torch, lambda: kernel(x, dt, A, Bm, Cm, dy, states))
    b_ms, b_by = bound(flops, nbytes, dtype)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, device_ms=dev_ms, host_ms=host_ms,
               library_device_ms=None, bytes=nbytes, flops=flops,
               states_bytes=states.numel() * 4,
               scratch_bytes=ssd_backward_scratch_bytes(
                   sops, B, S, H, P, N, int(dtype == "bfloat16")),
               library_note="no single PyTorch call computes the SSD "
                            "scan's backward",
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
    # gemma2-27b's attention where its window and softcap bind (phase 13):
    # an 8,192-token prefill of a local layer (window 4,096, softcap 50),
    # decode over a wrapped 4,096-slot local ring and over the 8,256-slot
    # global ring (softcap 50); timed in bf16
    gemma = dict(Hq=32, Hkv=16, Dh=128)
    for dtype in ("bfloat16", "float32"):
        flash_rows.append(dict(flash_case(
            torch, F, 1, GEMMA_BUCKET, dtype=dtype, kv_frac=None,
            window=GEMMA_WINDOW, softcap=50.0, timed=dtype == "bfloat16",
            **gemma), case="gemma2 local prefill"))
        decode_rows.append(dict(decode_case(
            torch, F, GEMMA_SLOTS, GEMMA_WINDOW, dtype=dtype,
            window=GEMMA_WINDOW, softcap=50.0, timed=dtype == "bfloat16",
            written=[4500, 5600, 6700, 7800], **gemma),
            case="gemma2 local ring, wrapped"))
        decode_rows.append(dict(decode_case(
            torch, F, GEMMA_SLOTS, GEMMA_MAX_LEN, dtype=dtype, window=None,
            softcap=50.0, timed=dtype == "bfloat16",
            written=[4500, 5600, 6700, 7800], **gemma),
            case="gemma2 global ring"))
    # hubert-xlarge's encoder (phase 16): bidirectional at head dim 80
    # over padded clips (keys past each clip masked, a row of length 0
    # averaging V), G = 1 and G = 4; bidirectional at head dim 128; and
    # hubert's batch of clips, timed in bf16
    hubert = dict(Hq=16, Hkv=16, Dh=80)
    for dtype in ("bfloat16", "float32"):
        flash_rows.append(flash_case(
            torch, F, 3, 200, dtype=dtype, kv_frac=None, window=None,
            softcap=None, timed=False, causal=False, kv_lens=[200, 77, 0],
            **hubert))
        flash_rows.append(flash_case(
            torch, F, 2, 300, 16, 4, 80, dtype=dtype, kv_frac=None,
            window=None, softcap=None, timed=False, causal=False))
        flash_rows.append(flash_case(
            torch, F, 2, 256, 32, 8, 128, dtype=dtype, kv_frac=None,
            window=None, softcap=None, timed=False, causal=False,
            kv_lens=[256, 131]))
        flash_rows.append(flash_case(
            torch, F, 1, 512, dtype=dtype, kv_frac=None, window=None,
            softcap=None, timed=False, causal=False, **llama))
        flash_rows.append(dict(flash_case(
            torch, F, len(HUBERT_CLIPS), HUBERT_FRAMES, dtype=dtype,
            kv_frac=None, window=None, softcap=None,
            timed=dtype == "bfloat16", causal=False,
            kv_lens=list(HUBERT_CLIPS), **hubert), case="hubert encoder"))
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
        # one rank's SSD heads of mamba2 at tp=2 (phase 21): x the rank's
        # channels, B and C whole
        ssd_rows.append(dict(ssd_case(
            torch, dtype=dtype, fused=True, timed=dtype == "bfloat16",
            **dict(mamba, H=mamba["H"] // MIXER_TP)),
            case="mamba2 tp=2 shard"))
    # the training forward at mamba2-2.7b's training shape, writing the
    # state entering each sub-chunk (phase 19 launches it twice a layer a
    # step under remat)
    from repro_torch.configs.registry import REGISTRY

    mamba_train = dict(B=TRAIN_BATCH, S=TRAIN_SEQ, H=80, P=64, N=128)
    per_step = 2 * REGISTRY[MAMBA_TRAIN_ARCH].n_layers
    for dtype in ("bfloat16", "float32"):
        ssd_rows.append(dict(ssd_case(
            torch, chunk=256, dtype=dtype, fused=True,
            timed=dtype == "bfloat16", train_states=True, **mamba_train),
            case="mamba2 training forward", launches_a_train_step=per_step))
    # the SSD backward (phase 19's training path): the sweep of
    # tests/test_kernels.py:237 and mamba2-2.7b's training shape (x, B and
    # C slices of one tensor), with and without a cotangent on the final
    # state, both dtypes; the training shape timed in bf16
    ssd_bwd_rows = []
    for dtype in ("bfloat16", "float32"):
        for dstate in (False, True):
            ssd_bwd_rows.append(ssd_backward_case(
                torch, dtype=dtype, dstate=dstate, fused=True,
                timed=dtype == "bfloat16" and not dstate, **mamba_train))
            for B, S, H, P, N in ((2, 256, 4, 64, 128), (1, 512, 8, 32, 64),
                                  (2, 128, 2, 64, 32), (1, 96, 4, 16, 16)):
                ssd_bwd_rows.append(ssd_backward_case(
                    torch, B, S, H, P, N, dtype, dstate, timed=False))
    # the training forward at minicpm-2b's training shape, writing its
    # lse (phase 18 launches it twice a layer a step under remat)
    per_step = 2 * REGISTRY[TRAIN_ARCH].n_layers
    for dtype in ("bfloat16", "float32"):
        flash_rows.append(dict(flash_case(
            torch, F, TRAIN_BATCH, TRAIN_SEQ, 36, 36, 64, dtype=dtype,
            kv_frac=None, window=None, softcap=None,
            timed=dtype == "bfloat16", train_lse=True),
            case="minicpm training forward", launches_a_train_step=per_step))
    # the flash backward (phase 18's training path): minicpm-2b's training
    # shape, llama's GQA, gemma2's window with its softcap and hubert's
    # bidirectional head dim 80; both dtypes, bf16 timed
    bwd_rows = []
    for dtype in ("bfloat16", "float32"):
        timed = dtype == "bfloat16"
        bwd_rows.append(flash_backward_case(
            torch, F, TRAIN_BATCH, TRAIN_SEQ, 36, 36, 64, dtype, True, None,
            None, timed))
        for case, shape in (
                ("llama GQA", (1, TRAIN_SEQ, 32, 8, 128, True, None, None)),
                ("gemma2 window softcap",
                 (1, TRAIN_SEQ, 32, 16, 128, True, 256, 50.0)),
                ("hubert bidirectional", (2, 750, 16, 16, 80, False, None,
                                          None))):
            bwd_rows.append(dict(flash_backward_case(
                torch, F, *shape[:5], dtype, *shape[5:], timed), case=case))
    # demo-8m (examples/train_small_torch.py, phase 23): float32 at head
    # dim 32, causal, its training forward (writing the lse) and its
    # backward, timed beside SDPA
    demo = dict(B=8, S=128, Hq=8, Hkv=4, Dh=32)
    flash_rows.append(dict(flash_case(
        torch, F, *demo.values(), dtype="float32", kv_frac=None,
        window=None, softcap=None, timed=True, train_lse=True),
        case="demo-8m float32",
        ptxas=PTXAS.get("flash_prefill", {}).get(
            "flash_prefill_kernel<float,32>")))
    bwd_rows.append(dict(flash_backward_case(
        torch, F, *demo.values(), "float32", True, None, None, True),
        case="demo-8m float32"))
    rows = {"flash_prefill": flash_rows, "flash_backward": bwd_rows,
            "ring_decode": decode_rows,
            "paged_decode": paged_rows[1],
            "paged_verify": paged_rows[SPEC_K + 1], "ssd_scan": ssd_rows,
            "ssd_backward": ssd_bwd_rows,
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
    print("ssd_backward worst error relative to each gradient's max, (dx, "
          "ddt, dA, dB, dC), by dtype: " + json.dumps(
              {d: [max(r["rel_err_dx_ddt_dA_dB_dC"][i] for r in ssd_bwd_rows
                       if r["dtype"] == d) for i in range(5)]
               for d in ("bfloat16", "float32")}))
    head = {name: next(r for r in rs if "ms" in r and "case" not in r)
            for name, rs in rows.items()}
    head.update({f"{name}@{r['case']}": r for name, rs in rows.items()
                 for r in rs if "ms" in r and "case" in r})
    errs = {name: {dtype: max(r["max_abs_err"] for r in rs
                              if r["dtype"] == dtype)
                   for dtype in ("bfloat16", "float32")}
            for name, rs in rows.items()}
    return head, errs


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------


def phase4_requests(cfg):
    """Phase 4's workload: 8 Poisson requests, prompts of 64-512 tokens
    and 16-64 decode steps, at the config's vocabulary."""
    from repro_torch.serving import poisson_workload
    from repro_torch.serving.workload import (
        DatasetDist, LengthDist, attach_tokens,
    )

    ds = DatasetDist(
        "smoke",
        prefill=LengthDist(200.0, 150.0, lo=64, hi=512),
        decode=LengthDist(32.0, 16.0, lo=16, hi=64),
    )
    return attach_tokens(poisson_workload(ds, 16.0, 1.0, seed=0)[:8],
                         cfg.vocab_size, seed=1)


def shortest_requests(cfg, n: int):
    """The ``n`` of phase 4's requests with the fewest decode steps (the
    earlier one on a tie), in arrival order: a cut of the workload that
    keeps its prompts and its batching, at the fewest iterations."""
    reqs = phase4_requests(cfg)
    keep = sorted(sorted(range(len(reqs)),
                         key=lambda i: (reqs[i].decode_len, i))[:n])
    return [reqs[i] for i in keep]


def kernel_layers(cfg, name: str) -> int:
    """Layers of ``cfg`` that launch kernel ``name`` once per call: the
    Mamba2 layers for the SSD scan, the attention layers otherwise."""
    if name == "ssd_scan":
        return cfg.n_layers - cfg.n_attn_layers
    return cfg.n_attn_layers


def ring_positions(cluster):
    """{ring capacity: the largest position a decode slot's ring holds}
    over the decode instances' dense caches, after the run: a ring that
    holds a position at or past its capacity has wrapped."""
    out = {}
    for e in cluster.decode:
        for entry in e.backend.cache.values():
            if "pos" in entry:
                cap = entry["pos"].shape[2]
                out[cap] = max(out.get(cap, -1), int(entry["pos"].max()))
    return out


def serve_phase(torch, arch, label, per_iter, params=None, tp=0,
                cuda_graphs=None, cfg=None, reqs=None, slots=SLOTS,
                max_len=MAX_LEN, recorder=None):
    """``arch`` at full width and depth in bf16 (random weights from a
    seeded generator) through the dense P/D cluster, one prefill and one
    decode instance, on ``reqs`` (phase 4's 8 Poisson requests by
    default), ``slots`` decode slots of ``max_len``.  ``per_iter`` maps
    each kernel the path runs to the iteration kind ("prefill" or
    "decode") that launches it once per layer that runs it
    (:func:`kernel_layers`); every other kernel must stay at 0.  With
    ``tp`` the instances are tp-wide slices of the world and ``params``
    this rank's shards; ``cfg`` with ``params`` serves a cut config.
    ``cuda_graphs`` goes to the backends (None: graphs for a meshless
    decode instance); ``recorder`` (a :class:`Recorder`) records the
    backends' calls.  Returns the config, params, requests, this run's
    launch counts and the printed stats."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.serving import ClusterConfig, PDCluster
    from repro_torch.serving import jitcache, loopprof
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_real_backend_factory

    cfg = cfg or REGISTRY[arch]
    if params is None:
        cfg, params = init_model(torch, arch)
    pred = build_predictor(cfg, A100, A100.freq_levels_2, kv_cap=400_000)
    # phase 4's workload whole, or a cut of it that still batches
    least = 4 if reqs is None else 2
    reqs = reqs if reqs is not None else phase4_requests(cfg)
    check(len(reqs) >= least, f"workload too small: {len(reqs)} requests")

    walls = {"prefill": [], "decode": []}
    base = make_real_backend_factory(cfg, params, slots=slots,
                                     max_len=max_len, tp=tp, device="cuda",
                                     cuda_graphs=cuda_graphs)

    def factory(kind, idx, hw, seed, tp=None):
        be = base(kind, idx, hw, seed, tp=tp)
        if be.local:  # an instance this rank computes
            be._real_prefill = timed(torch, be._real_prefill,
                                     walls["prefill"])
            be._real_decode_step = timed(torch, be._real_decode_step,
                                         walls["decode"])
        if recorder is not None:
            recorder.attach(be)
        return be

    ccfg = ClusterConfig(
        model=cfg, chip=A100, n_prefill=1, n_decode=1, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=slots, seed=0, tp=max(tp, 1),
        backend_factory=factory,
    )
    cluster = PDCluster(ccfg)
    prof = loopprof.install(cluster)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
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
        want = kernel_layers(cfg, name) * len(walls[kind]) if kind else 0
        # a mesh rank may compute no iteration of a kind (disjoint slices)
        ran = not kind or walls[kind] or not tp
        check(n == want and (n > 0 or not kind or not ran),
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
        "prefill_ms_mean": _mean(walls["prefill"]),
        "prefill_ms_median": _median(walls["prefill"]),
        "decode_iters": len(walls["decode"]),
        "decode_ms_mean": _mean(walls["decode"]),
        "decode_ms_median": _median(walls["decode"]),
        "decode_tokens": n_dec,
        "decode_tok_s": n_dec / dec_s if dec_s else None,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "sharded_launches": sharded_counts(dops),
        "head_launches": head_counts(),
        **graphs, **loop_split(prof),
        "step_device_ms": (step_device_ms(torch, cluster)
                           if graphs["cuda_graphs"] else None),
        "ring_max_position": (ring_positions(cluster) if cfg.has_attention
                              and not tp else None),
        "virtual_energy_j": m.energy_j(),
        "virtual_t_finish": [r.t_finish for r in reqs],
        "handoffs": handoff_stats(cluster),
    }
    print(f"serve[{label}]: " + json.dumps(stats))
    print(f"{label}: virtual-clock A100 model (not measured on this card): "
          f"ttft_p50_ms={s['ttft_p50_ms']} itl_p50_ms={s['itl_p50_ms']} "
          f"energy_j={s['energy_j']} epot_mj={s['epot_mj']}")
    return cfg, params, reqs, launches, stats


def _mean(xs):
    return statistics.fmean(xs) if xs else None


def _median(xs):
    return statistics.median(xs) if xs else None


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
    _, _, eager, _, stats = serve_phase(torch, arch, f"{label}-eager",
                                        per_iter, params=params,
                                        cuda_graphs=False)
    same = [r.output_tokens == e.output_tokens for r, e in zip(reqs, eager)]
    check(len(eager) == len(reqs) and all(same),
          f"{label}: graph replay and eager steps emitted different streams "
          f"(requests {[r.rid for r, ok in zip(reqs, same) if not ok]})")
    print(f"{label}: the eager serve emitted the same {len(reqs)} streams "
          "as the graph replays")
    free(torch)
    return eager, stats


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


def replay_phase(torch, models, r, kinds=None, max_len=MAX_LEN,
                 margin=REPLAY_MARGIN):
    """Replay ``r``'s stream alone (batch 1) through the plain-attention
    path of each model in ``models`` (name -> (cfg, params)), prompt
    first, then every emitted token, at the served ``max_len`` (the
    prompt's bucket and the cache capacity).  Token i must be within
    ``margin`` of the max logit of the model named ``kinds[i]`` (the
    first model's, by default): the one that chose it.  A MoE stream
    depends on its batch-mates through capacity drops: replay it with
    :func:`batch_replay` instead."""
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import _bucket

    names = list(models)
    dev = models[names[0]][1]["embed"].device
    kinds = kinds or [names[0]] * len(r.output_tokens)
    check(len(kinds) == len(r.output_tokens),
          f"rid {r.rid}: {len(kinds)} token kinds for "
          f"{len(r.output_tokens)} tokens")
    toks = torch.tensor(r.prompt_tokens, dtype=torch.int32, device=dev)
    pad = _bucket(len(toks), hi=max_len)
    buf = torch.zeros((1, pad), dtype=torch.int32, device=dev)
    buf[0, : len(toks)] = toks
    lengths = torch.tensor([len(toks)], dtype=torch.int32, device=dev)
    state = {}
    for name, (cfg, params) in models.items():
        state[name] = M.prefill(params, cfg, buf, lengths, max_len=max_len,
                                plain_attention=True)
    pos = lengths.clone()
    worst = {name: 0.0 for name in names}
    for i, (tok, kind) in enumerate(zip(r.output_tokens, kinds)):
        row = state[kind][0][0].double()
        gap = float(row.max() - row[tok])
        worst[kind] = max(worst[kind], gap)
        check(gap <= margin,
              f"rid {r.rid} token {i} ({kind}): emitted id {tok} is "
              f"{gap:.4f} below the plain path's max logit (margin "
              f"{margin})")
        t = torch.tensor([tok], dtype=torch.int32, device=dev)
        for name, (cfg, params) in models.items():
            state[name] = M.decode_step(params, cfg, t, state[name][1], pos,
                                        plain_attention=True)
        pos = pos + 1
    counts = {name: kinds.count(name) for name in names}
    print(f"replay rid {r.rid}: {len(r.output_tokens)} tokens {counts}, "
          f"worst gap to the plain path's max logit {worst} (margin "
          f"{margin})")


def state_phase(torch, cfg, params, r, label, whole_path: bool):
    """``r``'s prompt at its served bucket, prefilled through the kernel
    path and through the plain ``L.ssd_chunked`` path (a MoE layer of the
    plain path keeps the kernel path's experts where its own top-k
    differs by a near-tie: :class:`Routes`).

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

    routes = Routes(L, torch)  # a MoE's near-ties as the kernel path routed
    M.ssd_scan = spy
    try:
        with routes:
            routes.mode = "record"
            lk, ck = M.prefill(params, cfg, buf, lengths, max_len=MAX_LEN)
            routes.mode = "force"
            lp, cp = M.prefill(params, cfg, buf, lengths, max_len=MAX_LEN,
                               plain_attention=True)
    finally:
        M.ssd_scan = kernel
    n_mamba = cfg.n_layers - cfg.n_attn_layers
    check(len(seen) == n_mamba,
          f"state[{label}]: {len(seen)} scans for {n_mamba} Mamba2 layers")

    def scaled(got, want):
        return float((got.float() - want.float()).abs().max()) / (
            float(want.float().abs().max()) + 1e-30)

    per_layer = []
    for a, k, (y, st) in seen:
        yr, sr = L.ssd_chunked(*a, **k)
        per_layer.append(max(scaled(y, yr), scaled(st, sr)))
    # every Mamba2 layer's state, (layers, 1, H, P, N): block by block
    # of each pattern position
    sk, sp = (torch.cat([c[f"layer_{i}"]["ssm"]
                         for i, s in enumerate(cfg.block_pattern)
                         if s.mixer == "mamba"]) for c in (ck, cp))
    dims = tuple(range(1, sp.dim()))
    scale = sp.abs().amax(dim=dims)
    path = ((sk - sp).abs().amax(dim=dims) / (scale + 1e-30)).tolist()
    held = path if whole_path else path[:1]
    step = max(1, len(path) // 8)
    tol = SSD_TOL["bfloat16"]
    print(f"state[{label}]: rid {r.rid} prompt {n} at bucket "
          f"{buf.shape[1]}: ssm scale {float(scale.min()):.3g}-"
          f"{float(scale.max()):.3g}; same inputs, worst layer "
          f"{max(per_layer):.3g}; whole path, Mamba2 layers 0, {step}, "
          f"...: {[float(f'{e:.3g}') for e in path[::step]]}, worst "
          f"{max(path):.3g} (layer {path.index(max(path))}), held in "
          f"{'every layer' if whole_path else 'layer 0'}; tolerance {tol}; "
          f"logits max gap {float((lk - lp).abs().max()):.4g}; MoE near-ties "
          f"forced {routes.forced} of {routes.rows} routed rows")
    check(max(per_layer) <= tol,
          f"state[{label}]: ssd_scan disagrees with L.ssd_chunked on a "
          f"layer's own inputs ({max(per_layer)})")
    check(bool(torch.isfinite(sk).all()) and max(held) <= tol,
          f"state[{label}]: the kernel path's SSM state disagrees with the "
          f"plain path's ({max(held)})")


# ---------------------------------------------------------------------------
# Batch-faithful replay (MoE phases)
# ---------------------------------------------------------------------------


class Recorder:
    """Every call a served cluster's real backends make that decides a
    token, in call order, for :func:`batch_replay`: each prefill's inputs
    and ids, each insert's slot (and pages), each drafter prefill, and
    each decode-shaped step's inputs (every slot's row, free ones too),
    occupied rows and output ids.  It wraps the backends' methods and
    keeps device copies of what they pass (no host sync); what they
    compute is untouched."""

    def __init__(self):
        self.events = []
        self.backends = []

    def attach(self, be):
        import numpy as np
        import torch

        i = len(self.backends)
        self.backends.append(SimpleNamespace(
            slots=be.slots, max_len=be.max_len, paged=be.paged,
            page_size=getattr(be, "page_size", None),
            pool_pages=getattr(be, "pool_pages", None)))
        names = {id(be._decode_fn): "decode"}
        if be.spec_k:
            names.update({id(be._draft_fn): "draft",
                          id(be._verify_fn): "verify"})
        ev, rid = self.events, [None]

        def snap(kw):
            return {k: v.clone() if isinstance(v, torch.Tensor)
                    else np.array(v) for k, v in kw.items()
                    if not isinstance(v, dict)}

        def wrap(name, record):
            inner = getattr(be, name)

            def call(*a, **kw):
                out = inner(*a, **kw)
                record(out, *a, **kw)
                return out
            setattr(be, name, call)

        inner_prefill = be._real_prefill

        def real_prefill(r):
            rid[0] = r.rid
            return inner_prefill(r)

        be._real_prefill = real_prefill
        wrap("_prefill_fn", lambda out, params, **kw: ev.append(
            ("prefill", i, rid[0], snap(kw), out[0].clone())))
        if be.spec_k:
            wrap("_draft_prefill_fn", lambda out, params, **kw: ev.append(
                ("draft_prefill", i, None, snap(kw), None)))
        wrap("insert", lambda out, r: ev.append(
            ("insert", i, r.rid, be.slot_of[r.rid],
             be.block_tables[be.slot_of[r.rid]].copy() if be.paged
             else None)))
        inner_step, inner_spec = be._real_decode_step, be._real_spec_step

        def decode_step(reqs):
            ev.append(("rows", i, None, {be.slot_of[r.rid]: r.rid
                                          for r in reqs}, None))
            return inner_step(reqs)

        def spec_step(reqs, k, accepts):
            ev.append(("rows", i, None, {be.slot_of[r.rid]: (r.rid, a)
                                          for r, a in zip(reqs, accepts)},
                       None))
            return inner_spec(reqs, k, accepts)

        be._real_decode_step, be._real_spec_step = decode_step, spec_step
        wrap("_step", lambda out, entry, params, **kw: ev.append(
            ("step", i, names[id(entry)], snap(kw), out[0].clone())))


class Routes:
    """The MoE routings of one run, to force them on another (see
    :func:`batch_replay`).  Installed as ``L._route``: in ``record`` mode
    it keeps each call's experts in call order; in ``force`` mode the
    n-th call takes the n-th recorded experts where its own differ, after
    checking that each recorded expert's router logit lies within
    ``ROUTE_MARGIN`` of this call's k-th largest (a near-tie, not another
    routing), and renormalises its weights over them."""

    def __init__(self, L, torch):
        self.L, self.torch, self.inner = L, torch, L._route
        self.log, self.mode, self.i, self.forced, self.rows = [], None, 0, 0, 0
        self.worst = 0.0  # the largest forced near-tie, router logit

    def __call__(self, x, router, top_k, capacity_factor):
        probs, topw, tope, C = self.inner(x, router, top_k, capacity_factor)
        if self.mode == "record":
            self.log.append(tope.clone())
            return probs, topw, tope, C
        torch = self.torch
        served = self.log[self.i].to(tope.device)
        self.i += 1
        self.rows += tope.shape[0]
        differ = (tope.sort(-1).values != served.sort(-1).values).any(-1)
        n = int(differ.sum())
        if n == 0:
            return probs, topw, tope, C
        logp = torch.log(probs.double())
        kth = logp.gather(1, tope[:, -1:])  # this call's k-th largest
        gap = float((kth - logp.gather(1, served)).max())
        check(gap <= ROUTE_MARGIN,
              f"an expert the served path routed to is {gap:.4f} below the "
              f"plain path's top-{top_k} in router logit (margin "
              f"{ROUTE_MARGIN})")
        self.forced += n
        self.worst = max(self.worst, gap)
        w = probs.gather(1, served)
        return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), \
            served, C

    def __enter__(self):
        self.L._route = self
        return self

    def __exit__(self, *exc):
        self.L._route = self.inner


def batch_replay(torch, rec, target, draft=None, label="",
                 margin=REPLAY_MARGIN, served_routes=None):
    """Re-run the recorded calls of a served cluster (a :class:`Recorder`)
    batch for batch: every prefill from its own inputs, every insert into
    its slot (or pages), every decode, draft and verify step over all the
    slots it ran, with the served inputs.  A MoE layer routes each
    batch's rows as the served step did, capacity drops and all.

    Two passes.  The first runs the kernel path eagerly, which computes
    what the served instance computed (its graphs replay the same
    kernels), and records every MoE routing (:class:`Routes`).  The
    second runs the plain path (``plain_attention=True``, plain layers);
    where its router's top-k differs from the served one, the difference
    must be a near-tie (each served expert within ``ROUTE_MARGIN`` of
    the plain top-k in router logit), and the served experts are kept:
    a near-tie flipped by rounding moves a top-2 MoE's output far more
    than rounding does.  In both passes each id the served path emitted
    must lie within ``margin`` of its row's max logit: prefill ids and
    decode ids of occupied rows against the target, accepted drafts
    against the drafter's proposal step, verify tokens against the
    target's verify row.  ``target`` and ``draft`` are (cfg, params).
    ``served_routes``, the served run's MoE routings in call order (a mesh
    slice's, recorded by :class:`Routes` on a rank), replaces the first
    pass: the plain pass alone runs, forced to them.  The recorded
    inputs may lie on the host.  Returns the worst gaps by pass, the
    forced routings and the dropped MoE entries a target decode (or
    verify) step, counted from ``aux["dropped"]`` of the plain pass's
    eager steps."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import _put_slot

    cfg, params = target
    dev = params["embed"].device

    def dev_(kw):
        return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}

    def run(plain):
        path = "plain" if plain else "kernel"
        state = []
        for b in rec.backends:
            st = SimpleNamespace(rows={}, drafts=[])
            if b.paged:
                st.pool = M.init_paged_cache(cfg, b.pool_pages, b.page_size,
                                             dev)
            else:
                st.cache = M.init_cache(cfg, b.slots, b.max_len, dev)
            if draft is not None and b.slots > 1:
                st.dcache = M.init_cache(draft[0], b.slots, b.max_len, dev)
            state.append(st)
        handoff = {}
        worst = {"prefill": 0.0, "decode": 0.0, "draft": 0.0, "verify": 0.0}
        counted = {k: 0 for k in worst}
        drops, seen = [], []

        def held(kind, logits, tok, where):
            row = logits.double()
            gap = float(row.max() - row[int(tok)])
            worst[kind] = max(worst[kind], gap)
            counted[kind] += 1
            check(gap <= margin,
                  f"batch replay[{label}] {where} ({kind}): emitted id "
                  f"{int(tok)} is {gap:.4f} below the {path} path's max "
                  f"logit (margin {margin})")

        inner = L.moe_ffn_sorted

        def spy(*a, **kw):
            out, aux = inner(*a, **kw)
            seen.append(aux["dropped"])
            return out, aux

        L.moe_ffn_sorted = spy
        try:
            for kind, i, tag, kw, out in rec.events:
                st, geo = state[i], rec.backends[i]
                if kind == "prefill":
                    kw = dev_(kw)
                    if geo.paged:
                        logits, st.pool = M.prefill_paged(
                            params, cfg, cache=st.pool, plain_attention=plain,
                            **kw)
                        n = int(kw["ctx_lens"][0]) + int(kw["lengths"][0])
                        idx = kw["block_tables"][0, :-(-n // geo.page_size)]
                        handoff[tag] = {name: {k: leaf[:, idx.long()]
                                               for k, leaf in e.items()}
                                        for name, e in st.pool.items()}
                    else:
                        logits, handoff[tag] = M.prefill(
                            params, cfg, kw["tokens"], kw["lengths"],
                            max_len=geo.max_len, plain_attention=plain)
                    held("prefill", logits[0], out[0], f"rid {tag} prefill")
                elif kind == "draft_prefill":
                    kw = dev_(kw)
                    _, st.dnext = M.prefill(
                        draft[1], draft[0], kw["tokens"], kw["lengths"],
                        max_len=geo.max_len, plain_attention=plain)
                elif kind == "insert":  # kw: the slot; out: its table row
                    if geo.paged:
                        tree = handoff.pop(tag)
                        n = next(iter(tree.values()))["k"].shape[1]
                        dst = torch.from_numpy(out[:n]).long().to(dev)
                        for name, e in st.pool.items():
                            for k, leaf in e.items():
                                leaf[:, dst] = tree[name][k]
                    else:
                        _put_slot(st.cache, handoff.pop(tag), kw)
                    if draft is not None:
                        _put_slot(st.dcache, st.dnext, kw)
                elif kind == "rows":
                    st.rows, st.drafts = kw, []
                elif tag == "draft":
                    kw = dev_(kw)
                    logits, _ = M.decode_step(draft[1], draft[0],
                                              kw["tokens"], st.dcache,
                                              kw["lengths"],
                                              plain_attention=plain)
                    st.drafts.append((logits, out))
                else:  # a target decode or verify step
                    kw = dev_(kw)
                    del seen[:]
                    if tag == "verify":
                        logits, st.pool = M.verify_step_paged(
                            params, cfg, kw["tokens"], st.pool,
                            kw["lengths"], kw["block_tables"],
                            plain_attention=plain)
                    elif geo.paged:
                        logits, st.pool = M.decode_step_paged(
                            params, cfg, kw["tokens"], st.pool,
                            kw["lengths"], kw["block_tables"],
                            plain_attention=plain)
                    else:
                        logits, st.cache = M.decode_step(
                            params, cfg, kw["tokens"], st.cache,
                            kw["lengths"], plain_attention=plain)
                    drops.append(int(sum(seen)) if seen else 0)
                    for s, who in st.rows.items():
                        if tag != "verify":
                            held("decode", logits[s], out[s],
                                 f"rid {who} slot {s}")
                            continue
                        rid, a = who
                        # draft step 0 re-syncs; steps 1..k proposed
                        # d_1..d_k
                        for j in range(a):
                            dl, props = st.drafts[j + 1]
                            held("draft", dl[s], props[s],
                                 f"rid {rid} draft {j + 1}")
                        held("verify", logits[s, a], out[s, a],
                             f"rid {rid} slot {s}")
        finally:
            L.moe_ffn_sorted = inner
        return worst, counted, drops

    routes = Routes(L, torch)
    with routes:
        if served_routes is None:
            routes.mode = "record"
            kernel_worst, _, _ = run(plain=False)
        else:
            routes.log, kernel_worst = list(served_routes), None
        routes.mode = "force"
        worst, counted, drops = run(plain=True)
    check(routes.i == len(routes.log),
          f"batch replay[{label}]: {routes.i} plain routings for "
          f"{len(routes.log)} served ones")
    res = {"worst_gap": worst, "kernel_path_worst_gap": kernel_worst,
           "tokens_held": counted, "target_steps": len(drops),
           "routings": routes.rows, "near_ties_forced": routes.forced,
           "worst_near_tie": routes.worst,
           "dropped_per_step_mean": statistics.fmean(drops) if drops else 0,
           "dropped_per_step_max": max(drops, default=0)}
    print(f"batch replay[{label}]: " + json.dumps(res)
          + f" (margin {margin}, router margin {ROUTE_MARGIN}; drops "
          "counted on the plain pass's eager steps)")
    return res


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
                      label=None, recorder=None, n_turns=3):
    """Serve the multi-turn workload (``n_turns`` turns of its two
    conversations) over the paged pool with a radix
    prefix cache; with ``drafter`` (cfg, params) the decode instance
    speculates ``SPEC_K`` tokens per iteration; with ``tp`` the instances
    are tp-wide slices (``params`` this rank's shards); ``recorder`` (a
    :class:`Recorder`) records the backends' calls.  Returns the
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
    reqs = multiturn_workload(Request, cfg.vocab_size, n_turns=n_turns)
    walls = {"prefill": [], "decode": [], "spec": []}
    log = []
    base = make_real_backend_factory(
        cfg, params, slots=SLOTS, max_len=MAX_LEN, paged=True,
        page_size=PAGE_SIZE, pool_pages=POOL_PAGES, spec_k=spec_k,
        draft_cfg=drafter[0] if drafter else None,
        draft_params=drafter[1] if drafter else None, tp=tp, device="cuda")

    def factory(kind, idx, hw, seed, tp=None):
        be = base(kind, idx, hw, seed, tp=tp)
        if be.local:  # an instance this rank computes
            be._real_prefill = timed(torch, be._real_prefill,
                                     walls["prefill"])
            be._real_decode_step = timed(torch, be._real_decode_step,
                                         walls["decode"])
        if be.spec_k:
            inner = (timed(torch, be._real_spec_step, walls["spec"])
                     if be.local else be._real_spec_step)

            def step(rs, k, accepts):
                log.extend((r.rid, a) for r, a in zip(rs, accepts))
                return inner(rs, k, accepts)

            be._real_spec_step = step
        if recorder is not None:
            recorder.attach(be)
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
    zero_launch_counts()
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
    # on disjoint slices a rank launches only its own instances' kernels
    db = cluster.decode[0].backend
    check(launches["flash_prefill_q_offset"] > 0 or not pb.local,
          f"{phase}: the q-offset flash_prefill was never launched")
    if drafter:
        check(m.spec_iterations() > 0, "spec: no speculative iteration")
        check(dops.paged_launches.get(SPEC_K + 1, 0) > 0 or not db.local,
              f"spec: paged_verify never launched at T={SPEC_K + 1}")
    else:
        check(launches["paged_decode"] > 0 or not db.local,
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
        "prefill_ms_mean": _mean(walls["prefill"]),
        "prefill_ms_median": _median(walls["prefill"]),
        "iter_kind": "spec" if drafter else "decode",
        "iters": len(iters),
        "iter_ms_mean": _mean(iters),
        "iter_ms_median": _median(iters),
        "decode_tokens": n_dec,
        "decode_tok_s": n_dec / dec_s if dec_s else None,
        "spec_iterations": m.spec_iterations(),
        "acceptance_rate": m.acceptance_rate() if drafter else None,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "sharded_launches": sharded_counts(dops),
        "head_launches": head_counts(),
        "pool_pages_in_use": [e.backend.pool.in_use for e in cluster.decode],
        **graphs, **loop_split(prof),
        "step_device_ms": (step_device_ms(torch, cluster)
                           if graphs["cuda_graphs"] else None),
        "virtual_energy_j": m.energy_j(),
        "virtual_t_finish": [r.t_finish for r in reqs],
        "handoffs": handoff_stats(cluster, PAGE_SIZE),
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
            params=params, tp=world,
            reqs=phase4_requests(cfg)[:MESH_REQUESTS])
        serves["dense"] = (_streams(reqs), [], stats)
        reqs, log, _, stats = paged_serve_phase(
            torch, cfg, params, pred, tp=world,
            label=f"mesh-paged rank {rank}", n_turns=MESH_TURNS)
        serves["paged"] = (_streams(reqs), log, stats)
        dcfg = make_draft_config(cfg)
        dparams = M.init_params(
            dcfg, torch.Generator(device="cuda").manual_seed(1),
            device="cuda", mesh=mesh)
        reqs, log, _, stats = paged_serve_phase(
            torch, cfg, params, pred, drafter=(dcfg, dparams), tp=world,
            label=f"mesh-spec rank {rank}", n_turns=MESH_TURNS)
        serves["spec"] = (_streams(reqs), log, stats)
        del dparams, reqs, log
        res["int8"] = mesh_int8_serves(torch, cfg, params, pred, mesh, rank,
                                       serves)
        res.update(serves=serves, ok=True)
    except BaseException:  # the parent fails the phase with it
        res["error"] = traceback.format_exc()
    Path(out).write_bytes(pickle.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()


def serve_config(cfg, serve: str):
    """The config a serve named ``serve`` runs: ``int8-dense`` int8
    weights and an int8 ring, ``int8-paged`` and ``int8`` int8 weights,
    ``dispatch8`` int8 MoE dispatch; any other name ``cfg`` itself."""
    import dataclasses

    if serve == "dispatch8":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_dtype="int8"))
    if serve == "int8-dense":
        return dataclasses.replace(cfg, weight_dtype="int8", kv_dtype="int8")
    if serve in ("int8", "int8-paged"):
        return dataclasses.replace(cfg, weight_dtype="int8")
    return cfg


def int8_checksums(params) -> dict:
    """Per int8 leaf of ``params`` (``{path: [one sum a block]}``): its
    codes summed as int64 and its scales as float64, a stacked leaf
    block by block.  Sums of float32 scales of one magnitude in float64
    are exact, so they do not depend on how a leaf is cut."""
    import torch

    out = {}
    for name, leaf in named_leaves(params):
        if name.rsplit("/", 1)[-1] not in ("q8", "sc"):
            continue
        acc = torch.int64 if leaf.dtype == torch.int8 else torch.float64
        rows = leaf.reshape(leaf.shape[0], -1) if "/blocks/" in name \
            else leaf.reshape(1, -1)
        out[name] = rows.sum(dim=1, dtype=acc).tolist()
    return out


def slice_view(width: int):
    """A stand-in for rank 0 of a ``width``-wide ``(1, width)`` slice: the
    axis names and sizes the sharding rules read."""
    return SimpleNamespace(mesh_dim_names=("data", "model"),
                           shape=(1, width), get_local_rank=lambda a: 0)


def join_checksums(cfg, per_rank, width: int) -> dict:
    """The whole tree's :func:`int8_checksums` from each rank's of its
    shards: a leaf cut by its placement adds up over the ranks, a
    replicated one (a row-parallel leaf's scales) is the same on every
    rank and counts once."""
    from repro_torch.distributed import sharding as SH

    out = {}
    for name, sums in per_rank[0].items():
        spec = SH.leaf_placement(cfg, tuple(name.split("/")[1:]),
                                 slice_view(width))
        each = [r[name] for r in per_rank]
        check(not isinstance(spec, SH.Segments),
              f"int8 checksums: {name} is cut by segment")
        if spec.is_replicate():
            check(all(e == sums for e in each),
                  f"int8 checksums: the ranks' replicated {name} differ")
            out[name] = list(sums)
        else:
            out[name] = [sum(col) for col in zip(*each)]
    return out


def compare_checksums(got: dict, want: dict, label: str) -> int:
    """Fail unless two :func:`int8_checksums` agree leaf for leaf and
    block for block: codes exactly, scales within 1e-12 relative.
    Returns the leaves compared."""
    check(set(got) == set(want),
          f"{label}: checksums of {sorted(set(got) ^ set(want))[:4]} on "
          "one side only")
    for name in want:
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            ok = g == w if name.endswith("/q8") else \
                abs(g - w) <= 1e-12 * abs(w)
            check(ok and len(got[name]) == len(want[name]),
                  f"{label}: {name} block {i} sums to {g!r}, the meshless "
                  f"tree's {w!r}")
    return len(want)


def mesh_int8_serves(torch, cfg, params, pred, mesh, rank, serves) -> dict:
    """Phase 9's int8 serves on one rank: this rank's bf16 shards of
    llama quantized on the slice (``quantize_params(..., mesh,
    consume=True)``: each bf16 leaf freed as its int8 form is made, the
    absmax of a row-parallel leaf taken over ``"model"``) and their
    :func:`int8_checksums`; then ``MESH_INT8_REQUESTS`` of phase 4's
    requests (:func:`shortest_requests`) dense with an int8 ring and
    ``MESH_INT8_TURNS`` turns of phase 6's workload paged with int8
    weights, added to ``serves``.  Returns the quantization's wall, peak and bytes and the
    checksums."""
    from repro_torch.models import model as M

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.quantize_params(params, cfg, mesh, consume=True)
    torch.cuda.synchronize()
    out = {"quant_s": time.perf_counter() - t0,
           "quant_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held_gb": sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 1e9,
           "sums": int8_checksums(params)}
    free(torch)
    _, _, reqs, _, stats = serve_phase(
        torch, "llama-3.1-8b", f"mesh-int8-dense rank {rank}", ATTN_KERNELS,
        params=params, cfg=serve_config(cfg, "int8-dense"), tp=MESH_TP,
        reqs=shortest_requests(cfg, MESH_INT8_REQUESTS))
    serves["int8-dense"] = (_streams(reqs), [], stats)
    reqs, log, _, stats = paged_serve_phase(
        torch, serve_config(cfg, "int8-paged"), params, pred, tp=MESH_TP,
        label=f"mesh-int8-paged rank {rank}", n_turns=MESH_INT8_TURNS)
    serves["int8-paged"] = (_streams(reqs), log, stats)
    return out


def time_collectives(torch, mesh, iters: int = 50):
    """Synchronised wall ms per call of the model's two collectives on
    this world's backend: the sum of one row-parallel output at a decode
    step's 8 slots and a k = 2 verify step's 8 x 3 rows (x 4096, float32
    as the model sums its partial products unrounded, and bf16, the
    model's dtype, beside it), and the gather of the logits' vocabulary
    shards (8 x 128256 / tp, float32)."""
    from repro_torch.distributed.context import (
        gather_model, mesh_context, reduce_model,
    )

    calls = {}
    for rows in (SLOTS, SLOTS * (SPEC_K + 1)):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = torch.zeros((rows, 4096), dtype=dtype, device="cuda")
            calls[f"all_reduce {rows}x4096 {tag}"] = (
                lambda x=x: reduce_model(x))
    logits = torch.zeros((SLOTS, 128256 // MESH_TP), device="cuda")
    calls["gather 8x64128 f32"] = lambda: gather_model(logits)
    out = {}
    with mesh_context(mesh):
        for name, fn in calls.items():
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


def spawn_world(target, world: int, label: str, *args,
                timeout: float = MESH_TIMEOUT_S):
    """Run ``target(rank, world, init, out, *args)`` on ``world`` spawned
    ranks of the card, wait at most ``timeout`` seconds, kill what is
    left and check that every rank reported ok.  Returns each rank's
    results."""
    import multiprocessing as mp
    import pickle
    import tempfile

    ctx = mp.get_context("spawn")
    sys.stdout.flush()  # the ranks write to the same stream
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.pkl" for r in range(world)]
        procs = [ctx.Process(target=target, args=(
            r, world, f"file://{tmp}/store", str(outs[r]), *args))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
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
            print(f"{label} rank {r} failed:\n{res['error']}",
                  file=sys.stderr)
    check(not hung, f"{label}: ranks {hung} outlasted {timeout} s")
    check(all(res["ok"] for res in ranks), f"{label}: a rank failed")
    return ranks


def mesh_phase(torch, pred):
    """Spawn the phase 9 world and check what its ranks report: the
    sharded wrappers' errors and launches, every serve's completeness
    and launches, and the same streams on every rank.  Returns rank 0's
    results."""
    t0 = time.perf_counter()
    ranks = spawn_world(mesh_rank, MESH_TP, "mesh", pred)
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
    wrapper.update({f"int8-{serve}": wrapper[serve]
                    for serve in ("dense", "paged")})
    for name in MESH_SERVES:
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
                "decode_ms_median" if name.endswith("dense")
                else "iter_ms_median",
                "decode_tok_s", "max_memory_allocated_gb", "launches",
                "sharded_launches", "captures", "dispatch_s",
                "device_wait_s")
        print(f"serve[mesh-{name}] per rank: " + json.dumps(
            {c: [st[c] for _, _, st in per] for c in cols}))
    int8 = [res["int8"] for res in ranks]
    print("mesh-int8: llama's shards quantized on the slice, per rank: "
          + json.dumps({k: [q[k] for q in int8]
                        for k in ("quant_s", "quant_peak_gb", "held_gb")})
          + "; reckoned a rank " + json.dumps(
              reckon_gb(serve_config(config_of("llama-3.1-8b"),
                                     "int8-dense"), width=MESH_TP)))
    bf16 = {n: ranks[0]["serves"][n][2] for n in ("dense", "paged")}
    for n in ("dense", "paged"):
        st, key = ranks[0]["serves"][f"int8-{n}"][2], \
            "decode_ms_median" if n == "dense" else "iter_ms_median"
        print(f"mesh-int8-{n} against mesh-{n}, rank 0: iteration "
              f"{st[key]:.2f} ms against {bf16[n][key]:.2f} ms, peak "
              f"{st['max_memory_allocated_gb']:.2f} GB against "
              f"{bf16[n]['max_memory_allocated_gb']:.2f} GB a rank")
    ranks[0]["int8_sums"] = join_checksums(
        config_of("llama-3.1-8b"), [q["sums"] for q in int8], MESH_TP)
    return ranks[0]


# ---------------------------------------------------------------------------
# Phase 20: prefill and decode on disjoint ranks of the card
# ---------------------------------------------------------------------------

DISJOINT_WORLD = 2  # phase 20: the prefill instance on rank 0, decode on 1


def handoff_stats(cluster, page_size: int = 0):
    """The P→D handoffs the decode instances took, as this rank saw them
    (None on the meshless path): how many crossed ranks and how many
    stayed local (the same on every rank), and each one's context
    tokens, the bytes this rank sent and received, its wall ms (staging
    included) and the bytes the virtual clock prices for the context
    (``hw.kv_transfer_bytes``)."""
    if cluster.decode[0].backend.mesh is None:
        return None
    out = {"crossed": 0, "local": 0, "moves": []}
    for e in cluster.decode:
        be = e.backend
        out["crossed"] += be.handoffs["crossed"]
        out["local"] += be.handoffs["local"]
        for tokens, sent, received, ms in be.handoff_log:
            out["moves"].append({
                "tokens": tokens, "bytes_sent": sent,
                "bytes_received": received, "ms": ms,
                "clock_bytes": be.hw.kv_transfer_bytes(tokens,
                                                       page_size=page_size)})
    return out


def disjoint_rank(rank: int, world: int, init: str, out: str, pred) -> None:
    """Phase 20 on one rank: join a world of ``DISJOINT_WORLD`` ranks on
    the card, draw llama-3.1-8b's weights at full width and depth (both
    ranks compute: the prefill instance is a tp=1 slice on rank 0, the
    decode instance one on rank 1) and serve, eagerly, (a) phase 4's
    requests over the dense ring and (b) phase 6's multi-turn workload
    over the paged pool with radix reuse.  Writes its results (or its
    traceback) to ``out``."""
    import pickle
    import traceback

    sys.stdout.reconfigure(line_buffering=True, write_through=False)
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    res = {"ok": False}
    try:
        from repro_torch.configs.registry import REGISTRY
        from repro_torch.distributed import init_world
        from repro_torch.models import model as M

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["backend"] = init_world(rank, world, init, "cuda",
                                    timeout_s=300.0)
        cfg = REGISTRY["llama-3.1-8b"]
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        torch.cuda.synchronize()
        res["weights_gb"] = torch.cuda.memory_allocated() / 1e9
        res["ring_bytes"] = sum(
            t.numel() * t.element_size()
            for t in _leaves(M.init_cache(cfg, 1, MAX_LEN, "meta")))
        serves = {}
        _, _, reqs, _, stats = serve_phase(
            torch, "llama-3.1-8b", f"disjoint-dense rank {rank}",
            {"flash_prefill": "prefill", "ring_decode": "decode"},
            params=params, tp=1)
        serves["dense"] = (_streams(reqs), [], stats)
        reqs, log, _, stats = paged_serve_phase(
            torch, cfg, params, pred, tp=1,
            label=f"disjoint-paged rank {rank}")
        serves["paged"] = (_streams(reqs), log, stats)
        res.update(serves=serves, ok=True)
    except BaseException:  # the parent fails the phase with it
        res["error"] = traceback.format_exc()
    Path(out).write_bytes(pickle.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()


def disjoint_phase(torch, pred, phase4):
    """Spawn the phase 20 world and check what its ranks report: each
    rank's dense streams equal to phase 4's eager serve (``phase4``: its
    streams, virtual-clock finish times and energy) with the same
    virtual clock, every dense handoff crossing ranks with the whole B=1
    ring, the paged streams equal on both ranks, and each rank launching
    only its own instance's kernels.  Prints each crossing handoff's
    bytes and wall ms beside the bytes the clock prices, and each rank's
    peak and walls.  Returns (rank 0's results, the launches of each
    serve summed over the ranks)."""
    t0 = time.perf_counter()
    ranks = spawn_world(disjoint_rank, DISJOINT_WORLD, "disjoint", pred)
    streams4, t_finish4, energy4 = phase4
    for r, res in enumerate(ranks):
        got, _, st = res["serves"]["dense"]
        same = [a["output_tokens"] == b["output_tokens"]
                for a, b in zip(got, streams4)]
        check(len(got) == len(streams4) and all(same),
              f"disjoint-dense: rank {r} emitted other streams than phase "
              f"4's eager serve (requests "
              f"{[a['rid'] for a, ok in zip(got, same) if not ok]})")
        check(st["virtual_t_finish"] == t_finish4
              and st["virtual_energy_j"] == energy4,
              f"disjoint-dense: rank {r}'s virtual clock differs from phase "
              f"4's: t_finish {st['virtual_t_finish']} vs {t_finish4}, "
              f"energy {st['virtual_energy_j']} vs {energy4}")
        ho = st["handoffs"]
        check(ho["crossed"] == len(got) and ho["local"] == 0,
              f"disjoint-dense: rank {r} counted {ho['crossed']} crossing "
              f"and {ho['local']} local handoffs for {len(got)} requests")
        moved = [m["bytes_sent"] + m["bytes_received"] for m in ho["moves"]]
        check(moved == [res["ring_bytes"]] * len(got),
              f"disjoint-dense: rank {r} moved {moved} bytes, not the "
              f"whole ring's {res['ring_bytes']} a request")
    paged = [res["serves"]["paged"] for res in ranks]
    check(all(p[0] == paged[0][0] for p in paged),
          "disjoint-paged: the ranks emitted different streams")
    for name in ("dense", "paged"):
        per = [res["serves"][name][2] for res in ranks]
        prefill = [st["launches"]["flash_prefill"] for st in per]
        decode = [st["launches"]["ring_decode" if name == "dense"
                                 else "paged_decode"] for st in per]
        check(prefill[0] > 0 and prefill[1] == 0 and decode[0] == 0
              and decode[1] > 0,
              f"disjoint-{name}: flash_prefill {prefill} and decode "
              f"{decode} launches by rank: each rank must launch its own "
              "instance's kernels only")
        moves = [m for st in per for m in st["handoffs"]["moves"]
                 if m["bytes_received"]]
        check(all(m["bytes_received"] > 0 for m in moves) and moves,
              f"disjoint-{name}: no handoff reached rank 1")
        print(f"disjoint-{name}: crossing handoffs as rank 1 received them "
              "(context tokens, bytes moved, bytes the virtual clock "
              "prices, wall ms with staging): " + json.dumps(
                  [(m["tokens"], m["bytes_received"], m["clock_bytes"],
                    m["ms"]) for m in moves]))
        sent = [m["ms"] for m in per[0]["handoffs"]["moves"]
                if m["bytes_sent"]]
        print(f"disjoint-{name}: handoff medians: bytes moved "
              f"{_median([m['bytes_received'] for m in moves])}, clock "
              f"bytes {_median([m['clock_bytes'] for m in moves])}, wall ms "
              f"received {_median([m['ms'] for m in moves])}, sent "
              f"{_median(sent)} (rank 0: staging and send)")
        iters = "decode_ms_median" if name == "dense" else "iter_ms_median"
        print(f"serve[disjoint-{name}] per rank: " + json.dumps(
            {c: [st[c] for st in per] for c in (
                "prefill_ms_median", iters, "decode_tok_s",
                "max_memory_allocated_gb", "launches", "captures",
                "dispatch_s", "device_wait_s")}))
    print(f"disjoint: {DISJOINT_WORLD} ranks on one card, "
          f"{ranks[0]['backend']} backend (handoffs staged through pinned "
          f"host memory), llama weights {ranks[0]['weights_gb']:.2f} GB a "
          f"rank, {time.perf_counter() - t0:.1f} s wall")
    launches = {}
    for name in ("dense", "paged"):
        total = {}
        for res in ranks:
            for k, n in res["serves"][name][2]["launches"].items():
                if isinstance(n, int):
                    total[k] = total.get(k, 0) + n
        launches[f"disjoint-{name}"] = total
    return ranks[0], launches


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


def _scales_per_block(cfg) -> int:
    """float32 scales of one block's int8 weights: one per output channel
    of every quantized matrix (``quantize_params``), per expert for a
    MoE's, per tap for a Mamba2 conv."""
    d, n = cfg.d_model, 0
    for spec in cfg.block_pattern:
        if spec.mixer == "attn":
            n += cfg.q_dim + 2 * cfg.kv_dim + d
        else:
            m = cfg.mamba
            di = m.d_inner(d)
            n += 2 * di + 2 * m.d_state + m.n_heads(d) + m.d_conv + d
        if spec.ffn == "mlp":
            n += 2 * cfg.d_ff + d
        elif spec.ffn == "moe":
            e = cfg.moe
            n += e.num_experts * (1 + 2 * e.d_ff_expert + d)
    return n


def reckon_gb(cfg, slots=SLOTS, max_len=MAX_LEN, pool_pages=None,
              width: int = 1) -> dict:
    """What a serve of ``cfg`` holds on the card before the run, GB: its
    weights (bf16, or with ``weight_dtype="int8"`` the block matrices as
    int8 codes and float32 scales beside the bf16 embedding and head) and
    the decode instance's rings (``slots`` slots, K and V of every
    attention layer at its capacity: ``max_len``, or its window; int8
    codes and a float32 scale per position and head with
    ``kv_dtype="int8"``), the Mamba2 states of those slots where it has
    Mamba2 layers, and with ``pool_pages`` the paged pools of the
    prefill and the decode instance.  With ``width`` > 1, what one rank
    of a ``width``-wide slice holds: its shards by the sharding rules
    (:func:`expected_local_bytes`: bf16, or int8 codes with their scales
    cut as the codes are), its share of the kv heads where the attention
    heads split, and of the SSD heads (with B and C whole in the conv
    tail) where they split."""
    from repro_torch.models.model import cache_capacity

    kv_heads, ssd_shards = cfg.n_kv_heads, 1
    if width > 1:
        if cfg.n_heads % width == 0 and cfg.n_kv_heads % width == 0:
            kv_heads //= width
        if cfg.has_mamba and cfg.mamba.n_heads(cfg.d_model) % width == 0:
            ssd_shards = width
    per_head = (cfg.head_dim + 4 if cfg.kv_dtype == "int8"
                else cfg.head_dim * 2)
    kv = 2 * kv_heads * per_head  # K and V a position
    ring = sum(cache_capacity(cfg, spec, max_len) for spec in
               cfg.block_pattern if spec.mixer == "attn") * cfg.n_blocks
    weights = cfg.param_count() * 2
    if width > 1:
        import torch

        weights = expected_local_bytes(torch, cfg, width)
    elif cfg.weight_dtype == "int8":
        blocks = sum(cfg._layer_params(spec)[0]
                     for spec in cfg.block_pattern) * cfg.n_blocks
        weights += (4 * _scales_per_block(cfg) * cfg.n_blocks) - blocks
    out = {"weights_gb": weights / 1e9, "ring_gb": slots * ring * kv / 1e9}
    if cfg.has_mamba:
        m = cfg.mamba
        di = m.d_inner(cfg.d_model) // ssd_shards
        nh = m.n_heads(cfg.d_model) // ssd_shards
        per_slot = ((m.d_conv - 1) * (di + 2 * m.d_state) * 2
                    + nh * m.head_dim * m.d_state * 4)
        out["state_gb"] = (slots * per_slot * (cfg.n_layers - cfg.n_attn_layers)
                           / 1e9)
    if pool_pages is not None:
        out["pools_gb"] = (2 * (pool_pages + 1) * PAGE_SIZE * cfg.n_attn_layers
                           * kv / 1e9)
    return out


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


def config_of(arch, n_layers=None):
    """The registered ``arch`` at full width, at full depth or cut to
    ``n_layers``."""
    import dataclasses

    from repro_torch.configs.registry import REGISTRY

    cfg = REGISTRY[arch]
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def init_model(torch, arch, n_layers=None, **reckon):
    """``arch`` at full width in bf16, random weights from a seeded
    generator, at full depth or cut to ``n_layers``; prints its shape,
    size, the init's peak and what :func:`reckon_gb` reckons a serve
    holds (``reckon``: its slots, max_len, pool pages)."""
    from repro_torch.models import model as M

    cfg = config_of(arch, n_layers)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    mixers = []
    if cfg.mamba is not None:
        m = cfg.mamba
        mixers.append(f"d_inner {m.d_inner(cfg.d_model)}, "
                      f"{m.n_heads(cfg.d_model)} SSM heads of {m.head_dim}, "
                      f"state {m.d_state}")
    if cfg.has_attention:
        windows = sorted({s.window for s in cfg.block_pattern
                          if s.mixer == "attn" and s.window})
        mixers.append(
            f"{cfg.n_heads} q heads over {cfg.n_kv_heads} kv heads of "
            f"{cfg.head_dim} (G={cfg.n_heads // cfg.n_kv_heads})"
            + (f", windows {windows}" if windows else ""))
    if cfg.moe is not None:
        e = cfg.moe
        mixers.append(f"MoE {e.num_experts} experts of {e.d_ff_expert}, "
                      f"top-{e.top_k}, capacity factor {e.capacity_factor}")
    mixer = "; ".join(mixers)
    reckoned = ("; reckoned " + json.dumps(reckon_gb(cfg, **reckon))
                if cfg.has_attention and cfg.embed_inputs else "")
    extras = "".join(x for x, on in ((", tied head", cfg.tie_embeddings),
                                     (", q/k norm", cfg.qk_norm),
                                     (", attention softcap",
                                      cfg.attn_softcap),
                                     (", logit softcap", cfg.logit_softcap))
                     if on)
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

    fops.launches = fops.q_offset_launches = fops.backward_launches = 0
    dops.launches = 0
    dops.paged_launches.clear()
    sops.launches = sops.backward_launches = 0
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
# Phases 13-15: sliding window and mixture of experts at full width
# ---------------------------------------------------------------------------

# the configs of phases 13-15, and the depth phase 15 cuts jamba to (one
# super-block: the full 32 layers take 103 GB)
WINDOW_MOE = ("gemma2-27b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")
JAMBA_LAYERS = 8
ATTN_KERNELS = {"flash_prefill": "prefill", "ring_decode": "decode"}
CARD_GB = 76.0  # what a phase may reckon to hold of the card's 80 GB


def long_requests(cfg, n=4):
    """Phase 13's workload: ``n`` Poisson requests with prompts of
    4,500-7,500 tokens (the 8,192 bucket, past gemma2's 4,096 window) and
    16-64 decode steps."""
    from repro_torch.serving import poisson_workload
    from repro_torch.serving.workload import (
        DatasetDist, LengthDist, attach_tokens,
    )

    ds = DatasetDist("long",
                     prefill=LengthDist(6000.0, 1000.0, lo=4500, hi=7500),
                     decode=LengthDist(40.0, 16.0, lo=16, hi=64))
    reqs = poisson_workload(ds, 4.0, 4.0, seed=2)[:n]
    check(len(reqs) == n, f"long workload: {len(reqs)} requests")
    return attach_tokens(reqs, cfg.vocab_size, seed=3)


def window_masked(prompt: int, window: int):
    """(query positions, query-key pairs) that a causal window of
    ``window`` masks in a prefill of ``prompt`` tokens: query q loses the
    keys before q - window + 1."""
    n = max(0, prompt - window)
    return n, n * (n + 1) // 2


def peak_line(label, stats):
    print(f"{label}: peak {stats['max_memory_allocated_gb']:.2f} GB "
          f"allocated on {card_identity()}")


def gemma2_phase(torch):
    """Phase 13: gemma2-27b at full depth served dense with step graphs
    past its window: 4 slots of ``GEMMA_MAX_LEN`` (2 if the reckoning
    exceeds ``CARD_GB``), prompts in the 8,192 bucket, so every local
    layer's prefill masks by the window and every local ring wraps in
    decode; one stream replayed through the plain path at the same
    max_len.  Frees its weights; returns the launch counts and stats."""
    arch = "gemma2-27b"
    slots = GEMMA_SLOTS
    cfg, params = init_model(torch, arch, slots=slots, max_len=GEMMA_MAX_LEN)
    gb = reckon_gb(cfg, slots + 1, GEMMA_MAX_LEN)  # + the prefill slot
    if gb["weights_gb"] + gb["ring_gb"] > CARD_GB:
        slots = 2
    print(f"gemma2: {slots} decode slots of {GEMMA_MAX_LEN} (reckoned "
          f"{gb['weights_gb'] + gb['ring_gb']:.2f} GB at {GEMMA_SLOTS})")
    reqs = long_requests(cfg)
    _, _, reqs, launches, stats = serve_phase(
        torch, arch, "gemma2", ATTN_KERNELS, params=params, cfg=cfg,
        reqs=reqs, slots=slots, max_len=GEMMA_MAX_LEN)
    r = reqs[0]
    q_masked, pairs = window_masked(r.prompt_len, GEMMA_WINDOW)
    check(q_masked > 0, f"gemma2: the window masked nothing in rid {r.rid}")
    rings = stats["ring_max_position"]
    check(rings.get(GEMMA_WINDOW, -1) >= GEMMA_WINDOW,
          f"gemma2: no local ring wrapped: largest positions {rings}")
    print(f"gemma2: rid {r.rid}'s prefill ({r.prompt_len} tokens, bucket "
          f"{GEMMA_BUCKET}): the {GEMMA_WINDOW}-token window masked keys "
          f"for {q_masked} query positions, {pairs:,} query-key pairs per "
          f"head, in each of {cfg.n_layers // 2} local layers; largest "
          f"position held by capacity {rings}")
    peak_line("gemma2", stats)
    replay_phase(torch, {"target": (cfg, params)}, r, max_len=GEMMA_MAX_LEN)
    del params, reqs, r
    free(torch)
    return {"gemma2": (launches, stats)}


def moe_phase(torch):
    """Phase 14: qwen3-moe-30b-a3b at full depth: phase 4's requests
    served dense with step graphs and again eagerly (equal streams), then
    with int8 dispatch (``dispatch_dtype="int8"``) on the same weights,
    then the multi-turn workload paged + speculative at ``SPEC_K``, every
    serve but the eager twin (its streams are the graph serve's) replayed
    batch for batch (:func:`batch_replay`).  Frees its
    weights; returns the launch counts and stats by label."""
    import dataclasses

    from repro_torch.core.power import A100
    from repro_torch.models import model as M
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_draft_config

    arch = "qwen3-moe-30b-a3b"
    cfg, params = init_model(torch, arch, pool_pages=POOL_PAGES)
    out, streams = {}, {}
    for label, graphs in (("qwen3moe", None), ("qwen3moe-eager", False)):
        rec = Recorder() if graphs is None else None
        _, _, reqs, launches, stats = serve_phase(
            torch, arch, label, ATTN_KERNELS, params=params, cfg=cfg,
            cuda_graphs=graphs, recorder=rec)
        peak_line(label, stats)
        if rec is not None:  # the eager twin must emit the same streams
            stats["batch_replay"] = batch_replay(torch, rec, (cfg, params),
                                                 label=label)
        streams[label] = [list(r.output_tokens) for r in reqs]
        out[label] = (launches, stats)
        del rec, reqs
        free(torch)
    same = [a == b for a, b in zip(*streams.values())]
    check(len(same) == len(streams["qwen3moe"]) and all(same),
          "qwen3moe: graph replay and eager steps emitted different streams")
    print(f"qwen3moe: the eager serve emitted the same {len(same)} streams "
          "as the graph replays")
    # int8 dispatch on the same weights (dispatch and combine buffers as
    # int8 rows with float32 scales) on the first 4 requests, replayed
    # batch for batch
    icfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_dtype="int8"))
    rec = Recorder()
    _, _, reqs, launches, stats = serve_phase(
        torch, arch, "qwen3moe-int8", ATTN_KERNELS, params=params, cfg=icfg,
        recorder=rec, reqs=phase4_requests(cfg)[:4])
    peak_line("qwen3moe-int8", stats)
    stats["batch_replay"] = batch_replay(torch, rec, (icfg, params),
                                         label="qwen3moe-int8")
    out["qwen3moe-int8"] = (launches, stats)
    del rec, reqs
    free(torch)
    pred = build_predictor(cfg, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=SPEC_K)
    dcfg = make_draft_config(cfg)
    dparams = M.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rec = Recorder()
    reqs, log, launches, stats = paged_serve_phase(
        torch, cfg, params, pred, drafter=(dcfg, dparams),
        label="qwen3moe-spec", recorder=rec)
    peak_line("qwen3moe-spec", stats)
    check(any(a for _, a in log), "qwen3moe-spec: no draft was accepted")
    stats["batch_replay"] = batch_replay(torch, rec, (cfg, params),
                                         draft=(dcfg, dparams),
                                         label="qwen3moe-spec")
    out["qwen3moe-spec"] = (launches, stats)
    del params, dparams, rec, reqs, log
    free(torch)
    return out


def jamba_phase(torch):
    """Phase 15: jamba-v0.1-52b at full width cut to one super-block
    (``JAMBA_LAYERS``: 7 Mamba2 + 1 attention, MoE on every other layer)
    served dense with step graphs on phase 4's requests, replayed batch
    for batch, and the prefill SSM state of every Mamba2 layer held
    against the plain path's.  Frees its weights; returns the launch
    counts and stats."""
    from repro_torch.configs.registry import REGISTRY

    arch = "jamba-v0.1-52b"
    full = REGISTRY[arch]
    cfg, params = init_model(torch, arch, n_layers=JAMBA_LAYERS)
    print(f"jamba: depth cut from {full.n_layers} to {cfg.n_layers} layers "
          f"(one super-block; the full depth holds "
          f"{full.param_count() * 2 / 1e9:.2f} GB of bf16 weights)")
    rec = Recorder()
    _, _, reqs, launches, stats = serve_phase(
        torch, arch, "jamba", {**ATTN_KERNELS, "ssd_scan": "prefill"},
        params=params, cfg=cfg, recorder=rec)
    peak_line("jamba", stats)
    stats["batch_replay"] = batch_replay(torch, rec, (cfg, params),
                                         label="jamba")
    state_phase(torch, cfg, params, reqs[0], "jamba", whole_path=True)
    del params, rec, reqs
    free(torch)
    return {"jamba": (launches, stats)}


# ---------------------------------------------------------------------------
# Phase 21: Mamba2 heads and MoE experts over "model", two ranks of the card
# ---------------------------------------------------------------------------

MIXER_TP = 2  # phase 21: ranks of the world, each instance's slice width
MIXER_TIMEOUT_S = 900.0  # the parent's wait for the phase 21 world
# every layer's gloo collectives cost each step 1.9-15 ms, so the phase
# took 290.9-383.7 s on phase 4's 8 requests and phase 6's 3 turns; it
# serves fewer requests at full depth instead, which keeps every model's
# shards, collectives and per-rank memory whole
MIXER_REQUESTS = 4  # the first of phase 4's requests, each dense serve
MIXER_TURNS = 2  # of phase 6's multi-turn workload, the paged serve
MIXER_INT8_REQUESTS = 2  # of phase 4's requests (the shortest), int8 serves
# (label, arch, the depth it is cut to or None, its serves); each
# model is drawn on the slice, served, then freed.  The int8 serves
# (:func:`serve_config`) come last, dense, after the collective probe:
# "dispatch8" on the bf16 shards, "int8" on the shards quantized on the
# slice (qwen3-moe's bf16 shards and an int8 copy would pass the card)
MIXER_MODELS = (
    ("mamba2", "mamba2-2.7b", None, ("dense", "int8")),
    ("qwen3moe", "qwen3-moe-30b-a3b", None, ("dense", "paged", "dispatch8")),
    ("jamba", "jamba-v0.1-52b", JAMBA_LAYERS, ("dense",)),
)
MIXER_INT8 = ("int8", "dispatch8")
MIXER_PROBE_PROMPT = 512  # the prefill bucket the collective probe runs


def local_leaves(torch, cfg, width: int):
    """(leaf of the full tree on the meta device, the elements one rank
    of a ``width``-wide slice holds of it by the sharding rules); with
    ``weight_dtype="int8"`` the tree of int8 codes and float32 scales,
    each scale cut as its codes are."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    full = M.init_params(cfg, torch.Generator(), device="meta")
    if cfg.weight_dtype == "int8":
        full = M.quantize_params(full)
    for name, leaf in named_leaves(full):
        spec = SH.leaf_placement(cfg, tuple(name.split("/")[1:]),
                                 slice_view(width))
        n = leaf.numel()
        if isinstance(spec, SH.Segments):
            n = n // spec.size() * spec.size(width)
        elif not spec.is_replicate():
            n //= width
        yield leaf, n


def expected_local_params(torch, cfg, width: int) -> int:
    """What one rank of a ``width``-wide slice holds of ``cfg``'s
    parameters by the sharding rules: each leaf of the full tree (on the
    meta device) at its placement's local share."""
    return sum(n for _, n in local_leaves(torch, cfg, width))


def expected_local_bytes(torch, cfg, width: int) -> int:
    """The bytes of :func:`expected_local_params`' elements: int8 codes
    and float32 scales with ``weight_dtype="int8"``."""
    return sum(n * leaf.element_size()
               for leaf, n in local_leaves(torch, cfg, width))


def collective_probe(torch, cfg, params, mesh,
                     prompt: int = MIXER_PROBE_PROMPT):
    """Every collective of one prefill of a ``prompt``-token bucket and
    of one decode step at ``SLOTS`` slots on this rank's slice, each
    timed alone (synchronised): by kind ("all_reduce", the logits'
    "all_gather", the MoE layers' "moe_gather"), the calls, the bytes
    this rank puts in and the bytes a gather gives back, and the MoE
    gather's median wall ms a layer."""
    from repro_torch.distributed import context as ctx
    from repro_torch.models import model as M

    inner_reduce, inner_gather = ctx.reduce_model, ctx.gather_model
    log = []

    def logged(kind, fn, x, out_bytes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log.append((kind, x.numel() * x.element_size(),
                    out_bytes(out), (time.perf_counter() - t0) * 1e3))
        return out

    def reduce(x):
        return logged("all_reduce", lambda: inner_reduce(x), x,
                      lambda out: out.numel() * out.element_size())

    def gather(x, dim=-1):
        return logged("moe_gather" if dim == 0 else "all_gather",
                      lambda: inner_gather(x, dim=dim), x,
                      lambda out: out.numel() * out.element_size())

    g = torch.Generator(device="cuda").manual_seed(5)
    ctx.reduce_model, ctx.gather_model = reduce, gather
    out = {}
    try:
        with ctx.mesh_context(mesh):
            toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                                 device="cuda", dtype=torch.int32)
            lengths = torch.tensor([prompt], dtype=torch.int32,
                                   device="cuda")
            M.prefill(params, cfg, toks, lengths, max_len=MAX_LEN)
            out["prefill"], log[:] = list(log), []
            cache = M.init_cache(cfg, SLOTS, MAX_LEN, "cuda")
            step = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=g,
                                 device="cuda", dtype=torch.int32)
            M.decode_step(params, cfg, step, cache,
                          torch.full((SLOTS,), 100, dtype=torch.int32,
                                     device="cuda"))
            out["decode"] = list(log)
    finally:
        ctx.reduce_model, ctx.gather_model = inner_reduce, inner_gather
    res = {}
    for when, calls in out.items():
        kinds = {}
        for kind, sent, got, ms in calls:
            k = kinds.setdefault(kind, {"calls": 0, "bytes_in": 0,
                                        "bytes_out": 0, "ms": []})
            k["calls"] += 1
            k["bytes_in"] += sent
            k["bytes_out"] += got
            k["ms"].append(ms)
        for k in kinds.values():
            k["ms_total"] = sum(k["ms"])
            k["ms_median"] = _median(k.pop("ms"))
        res[when] = kinds
    return res


def moe_gather_bytes(bf16, int8) -> dict:
    """One MoE layer's gather, bytes a rank gets back, from two
    :func:`collective_probe` results (the bf16 shards' and int8
    dispatch's): by call (prefill, decode step), each beside the other
    and their ratio."""
    out = {}
    for when in ("prefill", "decode"):
        a, b = bf16[when]["moe_gather"], int8[when]["moe_gather"]
        check(a["calls"] == b["calls"],
              f"moe gather: {a['calls']} bf16 calls, {b['calls']} int8")
        out[when] = {"bf16": a["bytes_out"] // a["calls"],
                     "int8": b["bytes_out"] // b["calls"],
                     "ratio": b["bytes_out"] / a["bytes_out"]}
    return out


def host_events(rec):
    """A :class:`Recorder`'s events with every tensor on the host, to
    leave the rank."""
    import torch

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v

    return SimpleNamespace(
        backends=rec.backends,
        events=[tuple(host(x) for x in ev) for ev in rec.events])


def mixer_rank(rank: int, world: int, init: str, out: str, preds) -> None:
    """Phase 21 on one rank: join a world of ``MIXER_TP`` ranks on the
    card and, for each of ``MIXER_MODELS`` in turn, draw this rank's
    shards on a tp-wide slice (``init_params(mesh=)``, seed 0), serve
    through the tp=2 P/D cluster (both instances on the same ranks,
    eager) with its calls and its MoE routings recorded, probe one
    prefill's and one decode step's collectives, then free it.  Writes
    its results (or its traceback) to ``out``."""
    import pickle
    import traceback

    sys.stdout.reconfigure(line_buffering=True, write_through=False)
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    res = {"ok": False}
    try:
        from repro_torch.distributed import init_world, make_slice_mesh
        from repro_torch.models import layers as L
        from repro_torch.models import model as M

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["backend"] = init_world(rank, world, init, "cuda",
                                    timeout_s=300.0)
        mesh = make_slice_mesh(range(world), "cuda")
        res["models"] = {}
        for label, arch, n_layers, serves in MIXER_MODELS:
            cfg = config_of(arch, n_layers)
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = M.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda", mesh=mesh)
            torch.cuda.synchronize()
            got = {"init_s": time.perf_counter() - t0,
                   "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "local_params": sum(t.numel() for t in _leaves(params)),
                   "serves": {}}
            per_iter = {"ssd_scan": "prefill"} if cfg.has_mamba else {}
            if cfg.has_attention:
                per_iter.update(ATTN_KERNELS)
            for serve in serves:
                if serve in MIXER_INT8 and "collectives" not in got:
                    got["collectives"] = collective_probe(torch, cfg, params,
                                                          mesh)
                if serve == "int8":  # each bf16 leaf freed as it goes
                    t0 = time.perf_counter()
                    params = M.quantize_params(params, cfg, mesh,
                                               consume=True)
                    torch.cuda.synchronize()
                    got["quant_s"] = time.perf_counter() - t0
                    free(torch)
                scfg = serve_config(cfg, serve)
                rec, routes = Recorder(), Routes(L, torch)
                name = f"mixer-{label}-{serve} rank {rank}"
                with routes:
                    routes.mode = "record"
                    if serve == "paged":
                        reqs, _, _, stats = paged_serve_phase(
                            torch, cfg, params, preds[label], tp=world,
                            label=name, recorder=rec, n_turns=MIXER_TURNS)
                    else:
                        _, _, reqs, _, stats = serve_phase(
                            torch, arch, name, per_iter, params=params,
                            cfg=scfg, tp=world, recorder=rec,
                            reqs=shortest_requests(cfg, MIXER_INT8_REQUESTS)
                            if serve in MIXER_INT8
                            else phase4_requests(cfg)[:MIXER_REQUESTS])
                got["serves"][serve] = {
                    "streams": _streams(reqs), "stats": stats,
                    "decode_lens": [r.decode_len for r in reqs],
                    "record": host_events(rec),
                    "routes": [t.cpu() for t in routes.log]}
                del rec, routes, reqs
                if serve == "dispatch8":
                    got["collectives_dispatch8"] = collective_probe(
                        torch, scfg, params, mesh)
            if "collectives" not in got:
                got["collectives"] = collective_probe(torch, cfg, params,
                                                      mesh)
            res["models"][label] = got
            del params
            free(torch)
        res["ok"] = True
    except BaseException:  # the parent fails the phase with it
        res["error"] = traceback.format_exc()
    Path(out).write_bytes(pickle.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()


def mixer_checks(ranks, cfgs, width: int = MIXER_TP) -> None:
    """What phase 21's ranks must show, each model and serve (``cfgs``:
    label -> (config, the local parameters the rules give a rank)): the
    same streams on every rank, each ``decode_len + 1`` tokens long;
    each rank's local parameter count as the rules say; ssd_scan and
    flash_prefill launched at the rank's share of the SSD and query
    heads only, the decode wrapper's sharded branch at its share of the
    kv heads; every decode pool drained."""
    for label, (cfg, local) in cfgs.items():
        for r, res in enumerate(ranks):
            got = res["models"][label]["local_params"]
            check(got == local,
                  f"mixer-{label}: rank {r} holds {got:,} parameters, the "
                  f"rules give a rank {local:,}")
        serves = ranks[0]["models"][label]["serves"]
        for serve in serves:
            tag = f"mixer-{label}-{serve}"
            per = [res["models"][label]["serves"][serve] for res in ranks]
            check(all(p["streams"] == per[0]["streams"] for p in per),
                  f"{tag}: the ranks emitted different streams")
            for s, n in zip(per[0]["streams"], per[0]["decode_lens"]):
                check(len(s["output_tokens"]) == n + 1,
                      f"{tag}: rid {s['rid']} has {len(s['output_tokens'])} "
                      f"tokens, expected {n + 1}")
            for r, p in enumerate(per):
                st = p["stats"]
                heads = st["head_launches"]
                want = {}
                if cfg.has_mamba:
                    want["ssd_scan"] = str(
                        cfg.mamba.n_heads(cfg.d_model) // width)
                if cfg.has_attention:
                    want["flash_prefill"] = str(cfg.n_heads // width)
                for kernel, h in want.items():
                    check(set(heads[kernel]) == {h},
                          f"{tag}: rank {r} launched {kernel} at heads "
                          f"{heads[kernel]}, not only at its {h}")
                if cfg.has_attention:
                    fn = ("paged_decode_attention" if serve == "paged"
                          else "decode_attention")
                    key = f"{fn}/hkv{cfg.n_kv_heads // width}"
                    check(st["sharded_launches"].get(key, 0) > 0
                          and set(st["sharded_launches"]) == {key},
                          f"{tag}: rank {r} sharded launches "
                          f"{st['sharded_launches']}, expected {key} only")
                pools = st.get("pool_pages_in_use", [])
                check(all(n == 0 for n in pools),
                      f"{tag}: rank {r}'s decode pools hold {pools} pages")


def mixer_phase(torch, preds):
    """Reckon what each rank of the phase 21 world holds of every model
    (:func:`reckon_gb` at ``MIXER_TP``: its shards, rings, states and
    pools) and check that the ranks fit the card together, spawn the
    world, check what its ranks report
    (:func:`mixer_checks`), print each rank's walls, peaks and
    collectives, then replay every served stream through the meshless
    plain path on the full weights from the same seed, batch for batch,
    each MoE layer forced to the experts the slice routed to
    (:func:`batch_replay`).  Returns the launches of each serve by
    phase label, summed over the ranks, and each rank's flash_prefill
    and ssd_scan launches by head count, by phase label."""
    for label, arch, n_layers, serves in MIXER_MODELS:
        gb = reckon_gb(config_of(arch, n_layers),
                       pool_pages=POOL_PAGES if "paged" in serves else None,
                       width=MIXER_TP)
        held = sum(gb.values())
        print(f"mixer-{label}: reckoned a rank of {MIXER_TP} "
              f"{json.dumps(gb)}, {held:.2f} GB; {MIXER_TP} ranks on the "
              f"card {MIXER_TP * held:.2f} GB of {CARD_GB}")
        check(MIXER_TP * held <= CARD_GB,
              f"mixer-{label}: {MIXER_TP} ranks would hold "
              f"{MIXER_TP * held:.2f} GB, past {CARD_GB}")
    t0 = time.perf_counter()
    ranks = spawn_world(mixer_rank, MIXER_TP, "mixer", preds,
                        timeout=MIXER_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    cfgs = {}
    for label, arch, n_layers, _ in MIXER_MODELS:
        cfg = config_of(arch, n_layers)
        cfgs[label] = (cfg, expected_local_params(torch, cfg, MIXER_TP))
    mixer_checks(ranks, cfgs)
    launches, heads = {}, {}
    for label, (cfg, local) in cfgs.items():
        models = [res["models"][label] for res in ranks]
        print(f"mixer-{label}: {MIXER_TP} ranks on one card, "
              f"{ranks[0]['backend']} backend, {cfg.n_layers} layers, "
              f"{local:,} params a rank of {cfg.param_count():,}, init "
              f"{[round(m['init_s'], 1) for m in models]} s, init peaks "
              f"{[round(m['init_peak_gb'], 2) for m in models]} GB")
        print(f"mixer-{label} collectives per rank, one prefill of "
              f"{MIXER_PROBE_PROMPT} tokens and one decode step at {SLOTS} "
              "slots (calls, bytes in, bytes out, ms total, median ms a "
              "call; moe_gather: one a MoE layer): " + json.dumps(
                  [m["collectives"] for m in models]))
        if "quant_s" in models[0]:
            print(f"mixer-{label}: shards quantized on the slice in "
                  f"{[round(m['quant_s'], 2) for m in models]} s; reckoned "
                  "a rank " + json.dumps(reckon_gb(
                      serve_config(cfg, "int8"), width=MIXER_TP)))
        if "collectives_dispatch8" in models[0]:
            print(f"mixer-{label} MoE gather a layer, bytes a rank gets "
                  "back, bf16 rows against int8 dispatch (codes and row "
                  "scales): " + json.dumps(moe_gather_bytes(
                      models[0]["collectives"],
                      models[0]["collectives_dispatch8"])))
        for serve in models[0]["serves"]:
            per = [m["serves"][serve]["stats"] for m in models]
            iters = "iter_ms_median" if serve == "paged" \
                else "decode_ms_median"
            print(f"serve[mixer-{label}-{serve}] per rank: " + json.dumps(
                {c: [st[c] for st in per] for c in (
                    "prefill_ms_median", iters, "decode_tok_s",
                    "max_memory_allocated_gb", "launches",
                    "sharded_launches", "head_launches", "captures",
                    "dispatch_s", "device_wait_s")}))
            total = {}
            for st in per:
                for k, n in st["launches"].items():
                    if isinstance(n, int):
                        total[k] = total.get(k, 0) + n
            launches[f"mixer-{label}-{serve}"] = total
            heads[f"mixer-{label}-{serve}"] = [st["head_launches"]
                                                for st in per]
    print(f"mixer: world {world_s:.1f} s wall")
    # the meshless plain-path replays, on the full weights from seed 0
    for label, arch, n_layers, _ in MIXER_MODELS:
        cfg, params = init_model(torch, arch, n_layers=n_layers)
        for serve, got in ranks[0]["models"][label]["serves"].items():
            if serve == "int8":  # the last serve: the bf16 tree can go
                from repro_torch.models import model as M

                params = M.quantize_params(params, consume=True)
            batch_replay(torch, got["record"],
                         (serve_config(cfg, serve), params),
                         label=f"mixer-{label}-{serve}",
                         served_routes=got["routes"])
        del params
        free(torch)
    print(f"mixer: {time.perf_counter() - t0:.1f} s wall with the replays")
    return launches, heads


# ---------------------------------------------------------------------------
# Phases 16-17: hubert's encoder and int8 serving at full width
# ---------------------------------------------------------------------------


def launch_counts_now():
    """The wrappers' launch counts, by kernel, as the serve phases report
    them."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    return {"flash_prefill": fops.launches,
            "flash_prefill_q_offset": fops.q_offset_launches,
            "ring_decode": dops.launches,
            "paged": sum(dops.paged_launches.values()),
            "ssd_scan": sops.launches}


def zero_launch_counts():
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    fops.launches = fops.q_offset_launches = fops.backward_launches = 0
    fops.head_launches.clear()
    dops.launches = 0
    dops.paged_launches.clear()
    dops.sharded_launches.clear()
    sops.launches = sops.backward_launches = 0
    sops.head_launches.clear()


def head_counts():
    """flash_prefill's launches by query heads and ssd_scan's by SSD
    heads, as JSON keys: on a mesh slice, the rank's share."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    return {"flash_prefill": {str(h): n for h, n in
                              sorted(fops.head_launches.items())},
            "ssd_scan": {str(h): n for h, n in
                         sorted(sops.head_launches.items())}}


def hubert_frames(torch, d_model):
    """``HUBERT_CLIPS`` of seeded frame embeddings (the stubbed conv
    frontend's output), zero past each clip's length, and the lengths."""
    g = torch.Generator(device="cuda").manual_seed(16)
    B = len(HUBERT_CLIPS)
    x = torch.randn((B, HUBERT_FRAMES, d_model), generator=g, device="cuda")
    lengths = torch.tensor(HUBERT_CLIPS, dtype=torch.int32, device="cuda")
    x *= (torch.arange(HUBERT_FRAMES, device="cuda")[None]
          < lengths[:, None])[..., None]
    return x, lengths


def plain_frames(S: int) -> int:
    """The smallest length >= S that ``L.chunked_attention`` takes at its
    default chunks (512 queries, 1,024 keys; the reference's own rule):
    the plain path runs hubert's clips padded to it.  The extra frames
    are masked keys, so every valid frame attends to the same keys."""
    if S <= 512:
        return S
    step = 512 if S <= 1024 else 1024
    return -(-S // step) * step


def top(by_kernel, n=6):
    """The ``n`` kernels that took the most device time, {name: ms}."""
    return dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n])


def hubert_phase(torch):
    """Phase 16: hubert-xlarge at full width and depth in bf16 on four
    padded clips of frame embeddings: ``forward`` and ``lm_logits``
    through the kernel path (exactly one bidirectional flash_prefill
    launch a layer, no other kernel), timed by wall and device clock,
    then through the plain path (on the clips padded to
    :func:`plain_frames`); every valid frame's kernel-path class
    must lie within ``REPLAY_MARGIN`` of the plain path's max logit.  The
    serving factory must refuse hubert (no decode phase).  Frees its
    weights; returns the launch counts and stats."""
    from repro_torch.models import model as M
    from repro_torch.serving.realengine import make_real_backend_factory

    arch = "hubert-xlarge"
    cfg, params = init_model(torch, arch)
    x, lengths = hubert_frames(torch, cfg.d_model)
    B, S = x.shape[:2]

    def run():
        h, _ = M.forward(params, cfg, inputs_embeds=x, lengths=lengths)
        return M.lm_logits(params, cfg, h)

    def run_plain():
        xp = torch.nn.functional.pad(x, (0, 0, 0, plain_frames(S) - S))
        h, _ = M.forward(params, cfg, inputs_embeds=xp, lengths=lengths,
                         plain_attention=True)
        return M.lm_logits(params, cfg, h)[:, :S]

    free(torch)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    logits = timed(torch, run, walls)()
    launches = launch_counts_now()
    want = family_launches(cfg, 1, 0)
    check(launches == want,
          f"hubert: a forward launched {launches}, expected {want}")
    for _ in range(4):
        timed(torch, run, walls)()
    peak = torch.cuda.max_memory_allocated()
    # device time a forward, by kernel (torch.profiler's CUDA activity):
    # the sum is the device's busy time
    by_kernel = device_ms_by_kernel(torch, run, iters=3)
    zero_launch_counts()
    plain = run_plain()
    check(launch_counts_now() == {k: 0 for k in want},
          "hubert: the plain path launched a kernel")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(plain).all()),
          f"hubert: logits {tuple(logits.shape)} or non-finite values")
    worst, same, frames = 0.0, 0, 0
    for b, n in enumerate(HUBERT_CLIPS):
        ids = logits[b, :n].argmax(-1)
        row = plain[b, :n].double()
        gap = row.max(-1).values - row.gather(1, ids[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        same += int((ids == row.argmax(-1)).sum())
        frames += n
    check(worst <= REPLAY_MARGIN,
          f"hubert: a valid frame's kernel-path class is {worst:.4f} below "
          f"the plain path's max logit (margin {REPLAY_MARGIN})")
    refused = ""
    try:
        make_real_backend_factory(cfg, params, device="cuda")
    except ValueError as e:
        refused = str(e)
    check("no decode phase" in refused,
          f"hubert: the serving factory did not refuse it ({refused!r})")
    flops = 2.0 * (cfg.param_count() - cfg.vocab_size * cfg.d_model) \
        * B * S + 2.0 * cfg.vocab_size * cfg.d_model * B * S \
        + 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * S * sum(
            HUBERT_CLIPS)
    stats = {"clips": list(HUBERT_CLIPS), "frames_padded": S,
             "plain_frames_padded": plain_frames(S),
             "forward_ms_median": statistics.median(walls),
             "forward_ms_first": walls[0],
             "device_busy_ms": sum(by_kernel.values()),
             "flash_ms": by_kernel.get("flash_prefill_bf16_kernel"),
             "top_kernels_ms": top(by_kernel), "flops": flops,
             "max_memory_allocated_gb": peak / 1e9, "launches": launches,
             "worst_gap": worst, "same_class_frames": same,
             "valid_frames": frames}
    print(f"hubert[forward]: " + json.dumps(stats))
    print(f"hubert: the serving factory refused it: {refused}")
    peak_line("hubert", stats)
    del params, x, logits, plain
    free(torch)
    return {"hubert": (launches, stats)}


def int8_step_profile(torch, cfg, params):
    """Where an int8 decode step's device time goes: one eager step over
    ``SLOTS`` rows of ``MAX_LEN`` rings, by kernel (torch.profiler); and
    the dequantization of one block's ``w_gate`` in the port's one pass
    (``L.dequantize``) beside the two-pass form (codes to float32, times
    the scales, then to bf16), which rounds alike."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    g = torch.Generator(device="cuda").manual_seed(17)
    cache = M.init_cache(cfg, SLOTS, MAX_LEN, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (SLOTS,), generator=g,
                         device="cuda", dtype=torch.int32)
    lengths = torch.full((SLOTS,), MAX_LEN // 2, dtype=torch.int32,
                         device="cuda")
    by_kernel = device_ms_by_kernel(
        torch, lambda: M.decode_step(params, cfg, toks, cache, lengths),
        iters=3)
    w = params["blocks"]["layer_0"]["mlp"]["w_gate"]
    q8, sc = w["q8"][0], w["sc"][0].unsqueeze(-2)
    one = cuda_ms(torch, lambda: L.dequantize(q8, sc, torch.bfloat16), [()])
    two = cuda_ms(torch, lambda: (q8.float() * sc).to(torch.bfloat16), [()])
    check(torch.equal(L.dequantize(q8, sc, torch.bfloat16),
                      (q8.float() * sc).to(torch.bfloat16)),
          "int8: the one-pass dequantization rounds differently")
    out = {"step_busy_ms": sum(by_kernel.values()),
           "top_kernels_ms": top(by_kernel, 8),
           "w_gate_dequant_ms": {"one_pass": one, "two_pass": two,
                                 "shape": list(q8.shape)}}
    print("int8[step profile]: " + json.dumps(out))
    del cache
    free(torch)
    return out


def int8_phase(torch, mesh_sums=None):
    """Phase 17: llama-3.1-8b at full width and depth with int8 weights
    (initialised in bf16, quantized by ``quantize_params``, the bf16 tree
    freed) and an int8 ring: phase 4's requests served dense with step
    graphs, a stream replayed through the plain path on the same
    quantized weights and int8 rings, and the same requests served again
    eagerly (``cuda_graphs=False``), which must emit the same streams.
    With ``mesh_sums`` (phase 9's :func:`int8_checksums` of the shards
    its ranks quantized on the slice, joined) the meshless tree's must
    agree with them, leaf for leaf and block for block.  Frees its
    weights; returns the launch counts and stats by label."""
    import dataclasses

    from repro_torch.models import model as M

    arch = "llama-3.1-8b"
    cfg, params = init_model(torch, arch)
    cfg = dataclasses.replace(cfg, weight_dtype="int8", kv_dtype="int8")
    t0 = time.perf_counter()
    params = M.quantize_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    free(torch)
    held = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"int8: quantize_params in {quant_s:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB with the bf16 "
          f"tree; the int8 tree holds {held / 1e9:.3f} GB; reckoned "
          + json.dumps(reckon_gb(cfg)))
    if mesh_sums is not None:
        n = compare_checksums(mesh_sums, int8_checksums(params), "int8")
        print(f"int8: the checksums of phase 9's {MESH_TP} ranks' shards, "
              f"quantized on the slice, equal the meshless tree's in all "
              f"{n} leaves, block by block")
    int8_step_profile(torch, cfg, params)
    _, _, reqs, launches, stats = serve_phase(
        torch, arch, "int8", ATTN_KERNELS, params=params, cfg=cfg)
    peak_line("int8", stats)
    replay_phase(torch, {"target": (cfg, params)}, reqs[0])
    free(torch)
    _, _, eager, eager_launches, eager_stats = serve_phase(
        torch, arch, "int8-eager", ATTN_KERNELS, params=params, cfg=cfg,
        cuda_graphs=False)
    same = [r.output_tokens == e.output_tokens for r, e in zip(reqs, eager)]
    check(len(eager) == len(reqs) and all(same),
          "int8: graph replay and eager steps emitted different streams "
          f"(requests {[r.rid for r, ok in zip(reqs, same) if not ok]})")
    print(f"int8: the eager serve emitted the same {len(reqs)} streams as "
          "the graph replays")
    del params, reqs, eager
    free(torch)
    return {"int8": (launches, stats),
            "int8-eager": (eager_launches, eager_stats)}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 18: training minicpm-2b at full width and depth
# ---------------------------------------------------------------------------


def train_batch(torch, vocab: int, seed: int = 0):
    """``launch/train.py``'s synthetic batch, on the card."""
    import numpy as np

    from repro_torch.launch.train import synthetic_batch

    return synthetic_batch(np.random.default_rng(seed), vocab, TRAIN_BATCH,
                           TRAIN_SEQ, "cuda")


def train_launches(cfg, remat: bool = True) -> dict:
    """A train step's launches: each attention layer's flash_prefill and
    each Mamba2 layer's ssd_scan once in the forward and once more in the
    remat recompute, and each one's backward (flash_backward,
    ssd_backward) once."""
    per = {m: sum(s.mixer == m for s in cfg.block_pattern) * cfg.n_blocks
           for m in ("attn", "mamba")}
    fwd = 2 if remat else 1
    return {"flash_prefill": fwd * per["attn"],
            "flash_backward": per["attn"],
            "ssd_scan": fwd * per["mamba"], "ssd_backward": per["mamba"]}


def train_counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops

    return {"flash_prefill": fops.launches,
            "flash_backward": fops.backward_launches,
            "ssd_scan": sops.launches,
            "ssd_backward": sops.backward_launches}


def named_leaves(tree, prefix=""):
    """(path, leaf) in the training modules' leaf order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def kernel_group(name: str) -> str:
    """The group a profiled kernel's time is reported under."""
    if name.startswith("flash_prefill"):
        return "flash forward"
    if name.startswith(("dkdv", "dq_", "delta_")):  # both bodies' kernels
        return "flash backward"
    if name.startswith("ssd_"):  # the scan and its backward
        return "ssd"
    low = name.lower()
    if low == "kernel2" or any(w in low for w in (
            "gemm", "cutlass", "xmma", "cublas", "sm90", "nvjet")):
        return "cuBLAS"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise (AdamW, norms, RoPE, CE)"
    if "reduce" in low or "softmax" in low or "logsumexp" in low:
        return "reductions (CE, norms, global norm)"
    return "other"


def checkpoint_round_trip(torch, tmpdir: str):
    """At reduced size on the card: save after one step, take a step,
    restore, take the same step again; the two must agree bit for bit
    (params, moments, step and loss)."""
    import dataclasses

    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models import model as M
    from repro_torch.training import (
        CheckpointManager,
        TrainStepConfig,
        init_opt_state,
        make_train_step,
        wsd_schedule,
    )
    from repro_torch.training._tree import leaves

    cfg = dataclasses.replace(REGISTRY[TRAIN_ARCH].reduced(), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    opt = init_opt_state(params)
    step = make_train_step(cfg, TrainStepConfig(ce_chunk=64),
                           wsd_schedule(1, 10, 5, 1e-3))
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                         device="cuda", dtype=torch.int32)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -100
    batch = {"tokens": toks, "labels": labels}
    params, opt, _ = step(params, opt, batch)
    mgr = CheckpointManager(tmpdir, keep=1, async_write=True)
    mgr.save(1, {"params": params, "opt": opt})
    mgr.wait()
    params, opt, m1 = step(params, opt, batch)
    like = {"params": params, "opt": opt}
    restored, at = mgr.restore_latest(like, device="cuda")
    check(at == 1, f"checkpoint: restored step {at}, expected 1")
    p2, o2, m2 = step(restored["params"], restored["opt"], batch)
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(params) + leaves(opt), leaves(p2) + leaves(o2)))
    check(same and float(m1["loss"]) == float(m2["loss"]),
          "checkpoint: a step after restore differs from the same step "
          "without it")
    return {"config": cfg.name, "layers": cfg.n_layers, "bitwise": same,
            "leaves": len(leaves(like))}


def train_phase(torch, arch=TRAIN_ARCH, key="train", round_trip=True):
    """Phase 18 (phase 19 with ``arch`` mamba2-2.7b, ``key`` train-mamba
    and no ``round_trip``): ``arch`` at full width and depth in bf16
    trained on ``launch/train.py``'s synthetic batch (B=4, S=1,024),
    remat on, the CE over 512-token chunks.  Step 1's loss through the kernels against
    the plain path on the same weights, and every leaf's gradient against
    the plain path on a float32 copy of them (``TRAIN_GRAD_TOL``,
    ``TRAIN_GRAD_RATIO``); then
    ``TRAIN_STEPS`` steps of WSD on the one batch: exact launches a step
    (``train_launches``), a falling loss, the median step and tokens/s,
    the peak, one step's device time by kernel group; then the checkpoint
    round trip at reduced size.  Frees its weights; returns ``{key:
    (launch counts, stats)}``."""
    import dataclasses
    import tempfile

    from repro_torch.training import (
        TrainStepConfig,
        init_opt_state,
        make_train_step,
        wsd_schedule,
    )
    from repro_torch.training._tree import leaves, tree_map
    from repro_torch.training.trainstep import make_grad_fn

    cfg, params = init_model(torch, arch)
    batch = train_batch(torch, cfg.vocab_size)
    tcfg = TrainStepConfig(ce_chunk=TRAIN_CE_CHUNK, remat=True)
    want = train_launches(cfg)

    # step 1's loss and gradients: the kernel path, the plain path, and
    # the plain path on a float32 copy of the weights
    zero_launch_counts()
    (loss_p, _), grads_p = make_grad_fn(
        cfg, dataclasses.replace(tcfg, plain_attention=True))(params, batch)
    torch.cuda.synchronize()
    check(train_counts() == {k: 0 for k in want},
          "train: the plain path launched a kernel")
    (loss_k, _), grads_k = make_grad_fn(cfg, tcfg)(params, batch)
    torch.cuda.synchronize()
    got = train_counts()
    check(got == want, f"train: step 1's gradient launched {got}, "
                       f"expected {want}")
    loss_rel = abs(float(loss_k) / float(loss_p) - 1)
    check(math.isfinite(float(loss_k)) and loss_rel <= TRAIN_LOSS_TOL,
          f"train: step 1 loss {float(loss_k)} against the plain path's "
          f"{float(loss_p)} ({loss_rel:.3g} relative)")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    (loss_32, _), grads_32 = make_grad_fn(
        cfg32, dataclasses.replace(tcfg, plain_attention=True))(
        tree_map(lambda t: t.float(), params), batch)
    torch.cuda.synchronize()
    errs = []  # (leaf, kernel vs plain, kernel vs f32, plain vs f32)
    for (name, a), b, c in zip(named_leaves(grads_k), leaves(grads_p),
                               leaves(grads_32)):
        errs.append((name, rel_l2(a, b), rel_l2(a, c), rel_l2(b, c)))
    bad = [e for e in errs if not (math.isfinite(e[2]) and e[2] <= max(
        TRAIN_GRAD_TOL, TRAIN_GRAD_RATIO * e[3]))]
    check(not bad, "train: a leaf's gradient through the kernels is further "
                   f"from the float32 plain path's than the limit allows "
                   f"(leaf, vs plain, vs f32, plain vs f32): {bad[:3]}")
    col = {k: [e[i] for e in errs] for i, k in
           ((1, "kernel_vs_plain"), (2, "kernel_vs_f32"),
            (3, "plain_vs_f32"))}
    step1 = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
             "loss_f32": float(loss_32), "loss_rel": loss_rel,
             **{f"grad_rel_l2_{k}_max": max(v) for k, v in col.items()},
             **{f"grad_rel_l2_{k}_median": statistics.median(v)
                for k, v in col.items()},
             "worst_ratio_to_plain": max(e[2] / e[3] for e in errs),
             "leaves": len(errs)}
    print("train[step 1, kernel vs plain vs float32]: " + json.dumps(step1))
    print("train[step 1 by leaf: kernel vs plain, kernel vs f32, plain vs "
          "f32]: " + json.dumps({e[0]: [round(x, 5) for x in e[1:]]
                                 for e in errs}))
    del grads_p, grads_k, grads_32
    free(torch)

    # TRAIN_STEPS steps on the one batch
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg, wsd_schedule(
        warmup=2, stable=TRAIN_STEPS, decay=TRAIN_STEPS, peak_lr=1e-3))
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    zero_launch_counts()
    for i in range(TRAIN_STEPS):
        before = train_counts()
        params, opt, m = timed(torch, step, walls)(params, opt, batch)
        got = {k: n - before[k] for k, n in train_counts().items()}
        check(got == want, f"train: step {i + 1} launched {got}, expected "
                           f"{want}")
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]) and math.isfinite(
            float(m["grad_norm"])), f"train: step {i + 1} loss {losses[-1]}")
    launches = train_counts()
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0],
          f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    # one more step under the profiler: device time by kernel and group
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
    by_kernel, by_group = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0)
        if us:
            name = kernel_name(ev.key)
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
            grp = kernel_group(name)
            by_group[grp] = by_group.get(grp, 0.0) + us / 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(walls[1:])
    stats = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "ce_chunk": TRAIN_CE_CHUNK, "remat": True, "dtype": cfg.dtype,
             "params": sum(t.numel() for t in leaves(params)),
             "losses": losses, "step_ms": walls,
             "step_ms_median": med, "tokens_per_s": tokens / med * 1e3,
             "max_memory_allocated_gb": peak / 1e9,
             "launches": launches, "launches_per_step": want,
             "device_busy_ms": sum(by_group.values()),
             "device_ms_by_group": by_group,
             "top_kernels_ms": top(by_kernel, 8), "step1": step1}
    print(f"train[{cfg.name}]: " + json.dumps(stats))
    peak_line(key, stats)
    del params, opt, batch, m, prof
    free(torch)
    if round_trip:
        with tempfile.TemporaryDirectory() as d:
            stats["checkpoint"] = checkpoint_round_trip(torch, d)
        print("train[checkpoint round trip]: "
              + json.dumps(stats["checkpoint"]))
        free(torch)
    return {key: (launches, stats)}


def mamba_train_phase(torch):
    """Phase 19: mamba2-2.7b (64 layers, 80 SSM heads of 64, state 128)
    trained at full width and depth as phase 18: every Mamba2 layer's
    gradient through ``ssd_backward``."""
    return train_phase(torch, MAMBA_TRAIN_ARCH, key="train-mamba",
                       round_trip=False)


# ---------------------------------------------------------------------------
# Phase 22: the dry-run's prediction against the card
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "llama-3.1-8b"
DRYRUN_PROMPT = 512  # the prefill case's tokens (one row)
RESIDENT_TOL = 0.01  # resident bytes before the step, relative
PEAK_TOL = 0.25  # the step's transient peak over resident, relative ...
PEAK_SLACK = 64 * 2 ** 20  # ... or absolute, whichever is larger


def dryrun_case(torch, D, cfg, shape, label, base, params=None):
    """One step traced by ``launch/dryrun.py``'s tracer on meta tensors,
    then run on the card under the same counters (eagerly): equal launch
    counts and FLOPs, resident bytes before the step within
    ``RESIDENT_TOL``, the step's transient peak within ``PEAK_TOL`` or
    ``PEAK_SLACK``.  ``base`` is ``memory_allocated`` before the step's
    state (``params`` included, when given) was made.  Prints two
    predicted times beside the measured device ms, unchecked: the floor,
    the larger of the traced FLOPs at the card's peak and the traced
    resident bytes (weights, cache or optimizer state, inputs) read
    once; and the pre-fusion figure, which puts the traced bytes (each
    op's inputs and outputs, an upper estimate of the traffic) in place
    of the resident ones, so it is no lower bound."""
    from repro_torch.device import analysis_mode

    t0 = time.perf_counter()
    with analysis_mode():
        fn, args = D.build_cell(cfg, shape)
        pred = D.trace(fn, args)
    del fn, args
    trace_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(22)
    fn, args = D.build_cell(cfg, shape, device="cuda", params=params,
                            generator=g)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    got = D.trace(fn, args, track_memory=False)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base - resident
    busy_ms = sum(device_ms_by_kernel(torch, lambda: fn(*args),
                                      iters=1).values())
    walls = []
    timed(torch, fn, walls)(*args)
    flops_ms = pred.flops / PEAK_FLOP_S[cfg.dtype] * 1e3
    resident_ms = pred.resident_bytes / PEAK_BYTES_S * 1e3
    floor_ms = max(flops_ms, resident_ms)
    row = {"case": label, "shape": f"{shape.kind} B={shape.global_batch} "
           f"S={shape.seq_len}",
           "launches": {"predicted": pred.launches, "card": got.launches},
           "flops": {"predicted": pred.flops, "card": got.flops,
                     "aten": got.aten_flops, "kernels": got.kernel_flops},
           "bytes_prefusion": {"predicted": pred.bytes, "card": got.bytes},
           "resident_bytes": {"predicted": pred.resident_bytes,
                              "card": resident},
           "transient_peak_bytes": {"predicted": pred.transient_peak_bytes,
                                    "card": transient},
           "floor_ms": floor_ms,
           "floor_by": "operations" if flops_ms >= resident_ms else "bytes",
           "prefusion_bound_ms": max(
               flops_ms, pred.bytes / PEAK_BYTES_S * 1e3),
           "device_busy_ms": busy_ms, "busy_over_floor": busy_ms / floor_ms,
           "wall_ms": walls[0], "trace_s": trace_s}
    print(f"dryrun[{label}]: " + json.dumps(row))
    check(got.launches == pred.launches and got.launches,
          f"dryrun[{label}]: launches {got.launches} on the card, "
          f"{pred.launches} traced")
    check(got.flops == pred.flops, f"dryrun[{label}]: {got.flops} FLOPs on "
                                   f"the card, {pred.flops} traced")
    check(abs(resident - pred.resident_bytes) <= RESIDENT_TOL * resident,
          f"dryrun[{label}]: resident {resident} B on the card, "
          f"{pred.resident_bytes} traced")
    check(abs(transient - pred.transient_peak_bytes) <= max(
        PEAK_TOL * transient, PEAK_SLACK),
        f"dryrun[{label}]: transient peak {transient} B on the card, "
        f"{pred.transient_peak_bytes} traced")
    del fn, args, got
    return row


def dryrun_phase(torch):
    """Phase 22: the dry-run's tracer against the card on phase 4's
    llama-3.1-8b (a decode step at ``SLOTS`` slots of ``MAX_LEN``, then a
    ``DRYRUN_PROMPT``-token prefill; its weights, drawn once, are handed
    on to phase 4) and phase 18's minicpm-2b train step (B=4 x 1,024,
    remat; weights, optimizer state and batch its own, freed after).
    Returns (llama's config and params, the rows)."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import dryrun as D

    free(torch)
    base = torch.cuda.memory_allocated()
    cfg, params = init_model(torch, DRYRUN_ARCH)
    rows = [dryrun_case(torch, D, cfg, ShapeSuite("decode", "decode",
                                                  MAX_LEN, SLOTS),
                        "llama decode", base, params)]
    free(torch)
    rows.append(dryrun_case(torch, D, cfg, ShapeSuite(
        "prefill", "prefill", DRYRUN_PROMPT, 1), "llama prefill", base,
        params))
    free(torch)
    tcfg = config_of(TRAIN_ARCH)
    rows.append(dryrun_case(
        torch, D, tcfg, ShapeSuite("train", "train", TRAIN_SEQ, TRAIN_BATCH),
        "minicpm train", torch.cuda.memory_allocated()))
    free(torch)
    return cfg, params, rows


# ---------------------------------------------------------------------------
# Phase 23: examples/train_small_torch.py on the card
# ---------------------------------------------------------------------------

DEMO_STEPS = 20
DEMO_LOSS_TOL = 1e-5  # float32: step 1's loss, kernel path against plain


def train_small_phase(torch):
    """Phase 23: ``examples/train_small_torch.py``'s demo-8m (float32,
    head dim 32) for ``DEMO_STEPS`` steps on the card through the Dh 32
    float32 flash kernels: step 1's loss and every gradient leaf against
    the plain path on the same weights and batch, exact launches a step,
    a loss that falls, and a resume from the checkpoint that gives the
    loss the state in memory gives on the resumed run's batch."""
    import dataclasses
    import tempfile

    import numpy as np

    sys.path.insert(0, str(ROOT / "examples"))
    import train_small_torch as T

    from repro_torch.models import model as M
    from repro_torch.training._tree import leaves, unflatten
    from repro_torch.training.trainstep import TrainStepConfig, make_grad_fn

    cfg = T.model_config(False)
    batch, seq = 8, 128
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    first = T.zipf_batch(np.random.default_rng(1), batch, seq,
                         cfg.vocab_size, "cuda")
    tcfg = TrainStepConfig(microbatches=2, ce_chunk=min(128, seq))
    zero_launch_counts()
    (loss_p, _), grads_p = make_grad_fn(
        cfg, dataclasses.replace(tcfg, plain_attention=True))(params, first)
    check(train_counts()["flash_prefill"] == 0,
          "demo: the plain path launched a kernel")
    (loss_k, _), grads_k = make_grad_fn(cfg, tcfg)(params, first)
    torch.cuda.synchronize()
    rel = abs(float(loss_k) / float(loss_p) - 1)
    errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(leaves(grads_k), leaves(grads_p))]
    check(rel <= DEMO_LOSS_TOL and max(errs) <= BWD_TOL["float32"],
          f"demo: step 1 through the Dh 32 kernels against the plain path: "
          f"loss {rel:.3g} relative, worst leaf {max(errs):.3g}")
    per_grad = train_launches(cfg)
    check(train_counts() == per_grad,
          f"demo: one gradient launched {train_counts()}, expected "
          f"{per_grad}")
    del grads_p, grads_k
    with tempfile.TemporaryDirectory() as ck:
        zero_launch_counts()
        t0 = time.perf_counter()
        params, opt, losses = T.train(cfg, params, steps=DEMO_STEPS,
                                      batch=batch, seq=seq, ckpt_dir=ck,
                                      device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = {k: v * 2 * DEMO_STEPS for k, v in per_grad.items()}
        check(train_counts() == want, f"demo: {DEMO_STEPS} steps launched "
                                      f"{train_counts()}, expected {want}")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"demo: the loss did not fall: {losses}")
        kept = [t.clone() for t in leaves(params) + leaves(opt)]
        logged = []
        _, _, resumed = T.train(cfg, params, steps=DEMO_STEPS + 1,
                                batch=batch, seq=seq, ckpt_dir=ck,
                                device="cuda", log=logged.append)
    n = len(leaves(params))
    step = T.make_step(cfg, DEMO_STEPS + 1, seq)
    _, _, m = step(unflatten(params, kept[:n]), unflatten(opt, kept[n:]),
                   T.zipf_batch(np.random.default_rng(1), batch, seq,
                                cfg.vocab_size, "cuda"))
    check(f"resumed from checkpoint at step {DEMO_STEPS}" in logged
          and resumed == [float(m["loss"])],
          f"demo: the resumed step's loss {resumed} is not the state in "
          f"memory's {float(m['loss'])}")
    stats = {"config": cfg.name, "head_dim": cfg.head_dim,
             "dtype": cfg.dtype, "steps": DEMO_STEPS, "losses": losses,
             "wall_s": wall, "step1_loss_rel": rel,
             "step1_grad_rel_max": max(errs), "resumed_loss": resumed[0],
             "launches_per_step": {k: 2 * v for k, v in per_grad.items()}}
    print("demo[train_small_torch]: " + json.dumps(stats))
    del params, opt, kept
    free(torch)
    return stats


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
    "flash_backward": ("src/repro_torch/kernels/csrc/flash_backward.cu",
                       "src/repro/kernels/flash_attention/kernel.py:93",
                       "train"),
    "ssd_backward": ("src/repro_torch/kernels/csrc/ssd_backward.cu",
                     "src/repro/kernels/ssd/kernel.py:98", "train-mamba"),
}
# what a row's "replaces" cannot say alone
KERNEL_NOTES = {
    "flash_backward": "backward; the JAX package differentiates "
                      "L.chunked_attention with XLA",
    "ssd_backward": "backward; the JAX package differentiates "
                    "L.ssd_chunked with XLA",
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


def case_rows(head, name):
    """The kernel phase's timed rows of kernel ``name`` at a named
    model's shape (gemma2's, hubert's), by case."""
    return {key.split("@", 1)[1]: r for key, r in head.items()
            if key.startswith(name + "@") and key.split("@", 1)[1]
            not in ("shard",)}


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
            PTXAS[name] = ptxas_table(built[name][1])
            print(f"ptxas[{name}]: " + json.dumps(PTXAS[name]))
    if args.kernels_only:
        head, errs = kernel_phase(torch, F)
        lm_head_case(torch)
        print(f"total {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"src": str(src), "kernels": [
            {"name": name,
             "max_abs_err_by_dtype": errs.get(name) or errs[
                 name.split("@")[0]],
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

    seconds = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    head, errs = kernel_phase(torch, F)
    lm_head_case(torch)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # phases 22-23 first, on an empty card: the dry-run's accounting of
    # resident bytes reads the allocator
    cfg, params, dryrun_rows = dryrun_phase(torch)
    seconds["22"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    demo = train_small_phase(torch)
    seconds["23"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_kernels = {"flash_prefill": "prefill", "ring_decode": "decode"}
    cfg, params, reqs, dense_launches, _ = serve_phase(
        torch, "llama-3.1-8b", "dense", dense_kernels, params=params)
    replay_phase(torch, {"target": (cfg, params)}, reqs[0])
    eager, eager_stats = same_streams_eagerly(
        torch, reqs, "llama-3.1-8b", "dense", dense_kernels, params)
    # phase 20 holds its dense serve against this one
    phase4 = (_streams(eager), eager_stats["virtual_t_finish"],
              eager_stats["virtual_energy_j"])
    del reqs, eager
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
    seconds["4-8"] = time.perf_counter() - t0
    t0 = time.perf_counter()

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
    # every int8 stream, on the meshless quantization of the same weights
    # (phase 17 holds its checksums against the slice's)
    qparams = M.quantize_params(params)
    for name in ("int8-dense", "int8-paged"):
        for stream in mesh["serves"][name][0]:
            r = SimpleNamespace(**stream)
            r.rid = f"{r.rid} (mesh-{name})"
            replay_phase(torch, {"target": (serve_config(cfg, name),
                                            qparams)}, r)
    del qparams
    free(torch)
    seconds["9"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # phase 20, with phase 9's world gone: prefill and decode on
    # disjoint ranks; one paged stream replayed on the full weights
    disjoint, disjoint_launches = disjoint_phase(torch, pred, phase4)
    streams, _, _ = disjoint["serves"]["paged"]
    r = SimpleNamespace(**streams[-1])
    r.rid = f"{r.rid} (disjoint-paged)"
    replay_phase(torch, {"target": (cfg, params)}, r)
    # free llama and the drafter before phases 21 and 10-12
    del params, dparams, models, r
    free(torch)
    seconds["20"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # phase 21: Mamba2 heads and MoE experts over a 2-wide slice
    moe_pred = build_predictor(config_of("qwen3-moe-30b-a3b"), A100,
                               A100.freq_levels_2, kv_cap=400_000)
    mixer_launches, mixer_heads = mixer_phase(torch, {"qwen3moe": moe_pred})
    seconds["21"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    family = {}
    for arch in FAMILY_SERVED:
        family.update(family_serve_phase(torch, arch,
                                         spec=arch == "ministral-3b"))
    for arch in FAMILY_CHECKED:
        family[arch.split("-")[0]] = kernel_path_phase(torch, arch)
    seconds["10-12"] = time.perf_counter() - t0
    for n, phase in ((13, gemma2_phase), (14, moe_phase), (15, jamba_phase),
                     (16, hubert_phase),
                     (17, partial(int8_phase, mesh_sums=mesh["int8_sums"])),
                     (18, train_phase), (19, mamba_train_phase)):
        t0 = time.perf_counter()
        family.update(phase(torch))
        seconds[str(n)] = time.perf_counter() - t0

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")

    by_phase = {"dense": dense_launches, "paged": paged_launches,
                "spec": spec_launches, "mamba": mamba_launches}
    by_phase.update({f"mesh-{name}": mesh["serves"][name][2]["launches"]
                     for name in MESH_SERVES})
    by_phase.update(disjoint_launches)
    by_phase.update(mixer_launches)
    by_phase.update({name: launches
                     for name, (launches, _) in family.items()})
    rows = []
    for name, (source, replaces, phase) in KERNELS.items():
        h = head[name]
        n = by_phase[phase][name]
        check(n > 0, f"{name} was never launched in the {phase} phase")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            **({"note": KERNEL_NOTES[name]} if name in KERNEL_NOTES else {}),
            "launches": n, "launches_phase": phase,
            "launches_by_phase": {p: by_phase[p].get(name, 0)
                                  for p in by_phase},
            **({"launches_by_heads_per_rank": {
                p: [h[name] for h in hs] for p, hs in mixer_heads.items()
                if any(h[name] for h in hs)}}
               if name in ("flash_prefill", "ssd_scan") else {}),
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_dtype": errs[name], **timings(h),
            **{case: {"shape": r["shape"], **timings(r)}
               for case, r in case_rows(head, name).items()},
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
    print("dryrun[summary]: " + json.dumps([
        {"case": r["case"], "floor_ms": r["floor_ms"],
         "floor_by": r["floor_by"],
         "prefusion_bound_ms": r["prefusion_bound_ms"],
         "device_busy_ms": r["device_busy_ms"],
         "busy_over_floor": r["busy_over_floor"], "wall_ms": r["wall_ms"],
         "flops": r["flops"]["card"],
         "bytes_prefusion": r["bytes_prefusion"]["card"],
         "resident_bytes": r["resident_bytes"],
         "transient_peak_bytes": r["transient_peak_bytes"]}
        for r in dryrun_rows]))
    print("demo[summary]: " + json.dumps(
        {k: demo[k] for k in ("losses", "resumed_loss", "wall_s")}))
    print("seconds by phase: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))
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
