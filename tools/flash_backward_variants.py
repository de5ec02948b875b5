#!/usr/bin/env python
"""Variants of the port's flash backward, built and timed side by side on
one card.

Each variant is the committed ``src/repro_torch/kernels/csrc/
flash_backward.cu`` with a few text edits, compiled by its own ``nvcc``
(all started together):

* ``as_built``: no edit;
* ``split=1``, ``split=2``, ``split=G``: the items a (batch row, kv head,
  key tile) is cut into, forced instead of ``w_split``'s choice;
* ``stages=3``: a third (Q, dO) ring stage at head dim 64;
* ``order=reversed``: key tiles taken from the last to the first, each
  item's query tiles from the first, dQ partials added from the last key
  tile (the first one-pass design's order);
* ``dkdv=per_thread``: dK and dV stored thread by thread, not by TMA;
* ``kv_pairs=1``: one K/V tile pair at head dim 64 (the next item's K
  and V wait for the last item's dK/dV stores);
* ``counters``: clocks around every wait (writers: turn spin, idle;
  consumers: hand-off slot, ring, K/V, the dK/dV turn);
* ``phases``: clocks per consumer phase and per writer phase, and each
  block's start and finish on the global timer.

Every variant is held against the plain backward (errors relative to
each gradient's max, two calls bitwise equal, a batch row alone equal to
that row of the batch) in a child process with a time limit, so a hang
fails; then timed at ``chip_smoke.py``'s backward shapes with launches
queued behind a sleep (device time), variants in order and again in
reverse.  Instrumented variants also print their counters, as shares.

Run where ``nvcc`` and the card are::

    python tools/flash_backward_variants.py [--out FILE] [VARIANT ...]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/flash_backward_variants"

# checked against the plain backward: B, S, Hq, Hkv, Dh, causal, window,
# softcap (ragged S, G 1 / 4 / 12, windows, the softcap, each split)
CHECK = [
    (1, 128, 1, 1, 64, True, None, None), (2, 100, 8, 2, 64, True, None, None),
    (1, 130, 8, 4, 128, True, 24, 5.0), (3, 200, 4, 4, 64, True, None, None),
    (3, 1000, 4, 1, 128, True, None, None),
    (2, 300, 12, 1, 64, False, None, None),
    (2, 1000, 32, 8, 128, True, None, None),
    (2, 700, 8, 2, 128, True, 96, None), (2, 300, 4, 4, 64, True, 32, None),
    (1, 2048, 32, 8, 128, True, 512, None),
]
# timed: chip_smoke.py's backward rows
TIME = [
    ("minicpm", (4, 1024, 36, 36, 64, True, None, None)),
    ("llama", (1, 1024, 32, 8, 128, True, None, None)),
    ("gemma2", (1, 1024, 32, 16, 128, True, 256, 50.0)),
]
# the work items (tiles of 128 keys x 64 queries x one head) of each
# timed shape, for cycles per tile
TILES = {"minicpm": 10368, "llama": 2304, "gemma2": 1344}

SPLIT = "int w_split(const Params& p, int resident) {\n  const int G = p.Hq / p.Hkv;\n"


def clock(k: int, who: str, var: str) -> str:
    """Adds the clocks since ``var`` to counter k (one thread), restarts."""
    return (f"\n        if ({who}) {{ const long long n_ = clock64(); "
            f"atomicAdd(&dev_cnt[{k}], (unsigned long long)(n_ - {var})); "
            f"{var} = n_; }}\n")


def timed(k: int, who: str, body: str) -> str:
    """``body`` with its clocks added to counter k (one thread)."""
    return ("{ const long long t0_ = clock64();\n" + body +
            f"\n if ({who}) atomicAdd(&dev_cnt[{k}], "
            "(unsigned long long)(clock64() - t0_)); }\n")


COUNTER_DECL = [(
    "namespace {\n\nstruct Params {",
    "__device__ unsigned long long dev_cnt[32];\n"
    "__device__ unsigned long long dev_tm[2048];\n"
    "namespace {\n\nstruct Params {"), (
    'extern "C" const char* repro_flash_backward_error_string(int err) {',
    'extern "C" void dev_counters(unsigned long long* out, int reset) {\n'
    "  if (reset) {\n"
    "    unsigned long long z[32] = {};\n"
    "    cudaMemcpyToSymbol(dev_cnt, z, sizeof z);\n"
    "  } else {\n"
    "    cudaMemcpyFromSymbol(out, dev_cnt, sizeof(unsigned long long) * 32);\n"
    "  }\n}\n\n"
    'extern "C" void dev_times(unsigned long long* out) {\n'
    "  cudaMemcpyFromSymbol(out, dev_tm, sizeof(unsigned long long) * 2048);\n"
    "}\n\n"
    'extern "C" const char* repro_flash_backward_error_string(int err) {')]

# writer: turn spin 0, idle on dq_full 1, total 5, hand-offs 6;
# consumers: slot 2, ring 3, total 4, dK/dV turn 7, K/V 8
COUNTERS = COUNTER_DECL + [
    ("""          if (lane == 0)
            while (hopper::load_acquire(turn) != rank) {
            }
""", "          if (lane == 0) " + timed(0, "true", """            while (hopper::load_acquire(turn) != rank) {
            }""")),
    ("""      for (int par = 0;; par ^= 1) {
        hopper::mbar_wait(&dq_full[slot], par);
        const volatile int* md = s_dq + slot * 8;
        const int b = md[0];
        if (b < 0) break;
""", """      const long long tw0_ = clock64();
      for (int par = 0;; par ^= 1) {
        """ + timed(1, "lane == 0", "hopper::mbar_wait(&dq_full[slot], par);") + """
        const volatile int* md = s_dq + slot * 8;
        const int b = md[0];
        if (b < 0) {
          if (lane == 0) atomicAdd(&dev_cnt[5], (unsigned long long)(clock64() - tw0_));
          break;
        }
        if (lane == 0) atomicAdd(&dev_cnt[6], 1ull);
"""),
    ("""        hopper::mbar_wait(&dq_empty[slot], dq_par);
""", "        " + timed(2, "tw == 0", "hopper::mbar_wait(&dq_empty[slot], dq_par);")),
    ("""        hopper::mbar_wait(&full[stage], full_par);
""", "        " + timed(3, "tw == 0", "hopper::mbar_wait(&full[stage], full_par);")),
    ("""    int stage = 0, full_par = 0, slot = 0, dq_par = 1;
    for (int n = 0;; ++n) {
      const int kv = n % KV_BUFS;
      hopper::mbar_wait(&kv_full[kv], (n / KV_BUFS) & 1);""", """    int stage = 0, full_par = 0, slot = 0, dq_par = 1;
    const long long tc0_ = clock64();
    for (int n = 0;; ++n) {
      const int kv = n % KV_BUFS;
      """ + timed(8, "tw == 0", "hopper::mbar_wait(&kv_full[kv], (n / KV_BUFS) & 1);")),
    ("""    // no item left: stop every writer
""", """    if (tw == 0) atomicAdd(&dev_cnt[4], (unsigned long long)(clock64() - tc0_));
    // no item left: stop every writer
"""),
    ("""          while (hopper::load_acquire(turn) != it.s) {
          }
""", timed(7, "true", """          while (hopper::load_acquire(turn) != it.s) {
          }""")),
]

# consumer phases 10-17 and 22-24 (thread 0 of each warpgroup), writer
# phases 18-21 (lane 0), block start and finish (global timer)
PH = lambda k: clock(k, "tw == 0", "ph_")  # noqa: E731
WQ = lambda k: clock(k, "lane == 0", "wq_")  # noqa: E731
PHASES = COUNTER_DECL + [
    ("""    int stage = 0, full_par = 0, slot = 0, dq_par = 1;
    for (int n = 0;; ++n) {""", """    int stage = 0, full_par = 0, slot = 0, dq_par = 1;
    long long ph_ = clock64();
    for (int n = 0;; ++n) {"""),
    ("""      const WItem it = w_item(p, item);
""", PH(24) + """      const WItem it = w_item(p, item);
"""),
    ("""        hopper::mbar_wait(&full[stage], full_par);
""", """        hopper::mbar_wait(&full[stage], full_par);
""" + PH(10)),
    ("""        hopper::fence_regs(dpt);
""", """        hopper::fence_regs(dpt);
""" + PH(11)),
    ("""        hopper::named_sync(BAR_DS, W_CONSUMERS);
#pragma unroll""", PH(12) + """        hopper::named_sync(BAR_DS, W_CONSUMERS);
#pragma unroll"""),
    ("""        hopper::fence_proxy_async();

        // dV += P^T.dO""", """        hopper::fence_proxy_async();
""" + PH(13) + """
        // dV += P^T.dO"""),
    ("""        hopper::named_sync(BAR_DS, W_CONSUMERS);  // all of dS^T is there
""", """        hopper::named_sync(BAR_DS, W_CONSUMERS);  // all of dS^T is there
""" + PH(14)),
    ("""        hopper::fence_regs(dq);
        if (tw == 0) {""", """        hopper::fence_regs(dq);
""" + PH(15) + """        if (tw == 0) {"""),
    ("""        hopper::mbar_wait(&dq_empty[slot], dq_par);
        float* dst""", """        hopper::mbar_wait(&dq_empty[slot], dq_par);
""" + PH(16) + """        float* dst"""),
    ("""        hopper::mbar_arrive(&dq_full[slot]);
        if (++slot == SLOTS) {
          slot = 0;
          dq_par ^= 1;
        }
      }
""", """        hopper::mbar_arrive(&dq_full[slot]);
""" + PH(17) + """        if (++slot == SLOTS) {
          slot = 0;
          dq_par ^= 1;
        }
      }
"""),
    ("""      const size_t kvt = ((size_t)it.b * p.Hkv + it.hk) * p.n_kt + it.kt;""",
     PH(22) + """      const size_t kvt = ((size_t)it.b * p.Hkv + it.hk) * p.n_kt + it.kt;"""),
    ("""      }
    }
    // no item left""", """      }
""" + PH(23) + """    }
    // no item left"""),
    ("""        const int h = md[1], m = md[2], rank = md[3], count = md[4];
""", """        const int h = md[1], m = md[2], rank = md[3], count = md[4];
        long long wq_ = clock64();
"""),
    ("""          __syncwarp();
          fetch(acc, 0);""", WQ(21) + """          __syncwarp();
          fetch(acc, 0);"""),
    ("""            for (int k = 1; k < CHUNKS; ++k) fetch(acc, k);
            mma::cp_async_wait<0>();
""", """            for (int k = 1; k < CHUNKS; ++k) fetch(acc, k);
            mma::cp_async_wait<0>();
""" + WQ(18)),
    ("""        hopper::mbar_arrive(&dq_empty[slot]);
""", WQ(19) + """        hopper::mbar_arrive(&dq_empty[slot]);
"""),
    ("""          if (lane == 0) hopper::add_release(turn, 1);
""", """          if (lane == 0) hopper::add_release(turn, 1);
""" + WQ(20)),
    ("""  if (threadIdx.x >= W_CONSUMERS) {
    hopper::reg_dealloc<W_PRODUCER_REGS>();""", """  if (threadIdx.x == 0 && blockIdx.x < 1024) {
    unsigned long long g_;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));
    dev_tm[2 * blockIdx.x] = g_;
  }
  if (threadIdx.x >= W_CONSUMERS) {
    hopper::reg_dealloc<W_PRODUCER_REGS>();"""),
    ("""    // no item left: stop every writer""", """    if (threadIdx.x == 0 && blockIdx.x < 1024) {
      unsigned long long g_;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));
      dev_tm[2 * blockIdx.x + 1] = g_;
    }
    // no item left: stop every writer"""),
]

EDITS = {
    "as_built": [],
    "split=1": [(SPLIT, SPLIT + "  if (G % 1 == 0) return 1;\n")],
    "split=2": [(SPLIT, SPLIT + "  if (G % 2 == 0) return 2;\n")],
    "split=G": [(SPLIT, SPLIT + "  return G;\n")],
    "stages=3": [("  static constexpr int STAGES = 2;\n",
                  "  static constexpr int STAGES = DH == 64 ? 3 : 2;\n")],
    "order=reversed": [
        ("  it.kt = rest / (p.B * p.Hkv);",
         "  it.kt = p.n_kt - 1 - rest / (p.B * p.Hkv);"),
        ("  *m = it.qt0 + it.n_qt - 1 - u / it.n_h;",
         "  *m = it.qt0 + u / it.n_h;"),
        ("          md[3] = it.kt - kt_lo;", "          md[3] = kt_hi - it.kt;")],
    "dkdv=per_thread": [(
        "      const bool tma_out =\n"
        "          last && it.n_qt > 0 && (KV_BUFS > 1 || p.n_split == 1);",
        "      const bool tma_out = false;")],
    "kv_pairs=1": [("  static constexpr int KV_BUFS = DH == 64 ? 2 : 1;",
                    "  static constexpr int KV_BUFS = 1;")],
    "counters": COUNTERS,
    "phases": PHASES,
}


def variant_source(name: str) -> str:
    text = (CSRC / "flash_backward.cu").read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def slug(name: str) -> str:
    return name.replace("=", "_")


def build(names):
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"fb_{slug(name)}.cu"
        src.write_text(variant_source(name).replace(
            '#include "', f'#include "{CSRC}/'))
        so = OUT / f"fb_{slug(name)}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(json.dumps({"built": name, "ptxas_spills": spills}), flush=True)
        built.append(name)
    return built


def load(name):
    lib = ctypes.CDLL(str(OUT / f"fb_{slug(name)}.so"))
    fn = lib.repro_flash_backward
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    sizes = []
    for kind in ("floats", "ints"):
        size = getattr(lib, f"repro_flash_backward_scratch_{kind}")
        size.argtypes = [ctypes.c_int] * 7
        size.restype = ctypes.c_longlong
        sizes.append(size)
    lib.repro_flash_backward_body.argtypes = [ctypes.c_int] * 2
    lib.repro_flash_backward_split.argtypes = [ctypes.c_int] * 8
    lib.repro_flash_backward_error_string.argtypes = [ctypes.c_int]
    lib.repro_flash_backward_error_string.restype = ctypes.c_char_p
    return lib, (fn, tuple(sizes), lib.repro_flash_backward_body,
                 lib.repro_flash_backward_error_string)


def child(names, out_path):
    import torch

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_backward_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {n: load(n) for n in names}

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        with open(out_path, "a") as out:
            out.write(line + "\n")

    def use(n):
        fops._bwd = libs[n][1]
        fops._backward_scratch_sizes.cache_clear()

    def split(n, sh):
        _, S, Hq, Hkv, Dh, causal, window, _ = sh
        return libs[n][0].repro_flash_backward_split(
            S, S, Hq, Hkv, Dh, int(causal), window or 0, 1)

    def inputs(sh, seed):
        B, S, Hq, Hkv, Dh, causal, window, softcap = sh
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, dout = (
            torch.randn(s, generator=g, device="cuda").bfloat16()
            for s in ((B, S, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                      (B, S, Hq, Dh)))
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")
        o = fops._launch(q, k, v, causal, window, softcap, None, None, lse)
        return q, k, v, o, dout, lse

    bad = 0
    for sh in CHECK:
        B, S, Hq, Hkv, Dh, causal, window, softcap = sh
        q, k, v, o, dout, lse = inputs(sh, S + Dh + Hq)
        kw = dict(causal=causal, window=window, softcap=softcap)
        want = attention_backward_ref(q, k, v, dout, **kw)
        for n in names:
            use(n)
            got = fops.flash_backward(q, k, v, o, dout, lse, **kw)
            again = fops.flash_backward(q, k, v, o, dout, lse, **kw)
            alone = fops.flash_backward(
                *(t[-1:].contiguous() for t in (q, k, v, o, dout, lse)), **kw)
            torch.cuda.synchronize()
            rel = [float((a.float() - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(got, want)]
            ok = (max(rel) <= 2e-2
                  and all(torch.equal(a, b) for a, b in zip(got, again))
                  and all(torch.equal(a[-1], b[0])
                          for a, b in zip(got, alone)))
            bad += not ok
            emit({"check": n, "case": sh, "split": split(n, sh), "rel": rel,
                  "ok": ok})
        del want
    data = {label: inputs(sh, 7) for label, sh in TIME}
    for n in names + names[::-1]:
        use(n)
        for label, sh in TIME:
            B, S, Hq, Hkv, Dh, causal, window, softcap = sh
            q, k, v, o, dout, lse = data[label]

            def run():
                return fops.flash_backward(q, k, v, o, dout, lse,
                                           causal=causal, window=window,
                                           softcap=softcap)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(4e6))  # the launches queue behind it
            e0.record()
            for _ in range(20):
                run()
            e1.record()
            torch.cuda.synchronize()
            row = {"variant": n, "shape": label, "split": split(n, sh),
                   "device_ms": e0.elapsed_time(e1) / 20}
            lib = libs[n][0]
            if n in ("counters", "phases"):
                cnt = (ctypes.c_ulonglong * 32)()
                lib.dev_counters(cnt, 1)
                run()
                torch.cuda.synchronize()
                lib.dev_counters(cnt, 0)
                row.update(shares(n, list(cnt), TILES[label]))
                if n == "phases":
                    tm = (ctypes.c_ulonglong * 2048)()
                    lib.dev_times(tm)
                    start = [tm[2 * i] for i in range(1024) if tm[2 * i]]
                    end = [tm[2 * i + 1] for i in range(1024)
                           if tm[2 * i + 1]]
                    span = max(end) - min(start)
                    row["blocks_idle_at_end_share"] = (
                        sum(max(end) - e for e in end) / len(end) / span)
            emit(row)
    return bad


def shares(name, c, tiles):
    if name == "counters":
        return {"writer_turn_spin": c[0] / max(c[5], 1),
                "writer_idle": c[1] / max(c[5], 1),
                "consumer_slot_wait": c[2] / max(c[4], 1),
                "consumer_ring_wait": c[3] / max(c[4], 1),
                "consumer_kv_wait": c[8] / max(c[4], 1),
                "consumer_dkdv_turn_wait": c[7] / max(c[4], 1),
                "handoffs": c[6]}
    consumer = ["ring_wait", "s_dp", "exp_ds", "ds_store", "dv_dk_issue",
                "dq_product", "slot_wait", "slot_write"]
    tot = max(sum(c[10:18]) + sum(c[22:25]), 1)
    row = {k: v / tot for k, v in zip(consumer, c[10:18])}
    row.update({k: v / tot for k, v in zip(
        ["before_dkdv", "dkdv_out", "next_item"], c[22:25])})
    row["consumer_cycles_a_tile"] = tot / 2 / tiles
    wtot = max(sum(c[18:22]), 1)
    row.update(writer_turn_spin=c[21] / wtot, writer_fetch=c[18] / wtot,
               writer_add_store=c[19] / wtot, writer_release=c[20] / wtot,
               writer_cycles_a_handoff=wtot / tiles)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(EDITS))
    ap.add_argument("--out", default=str(OUT / "variants.jsonl"))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return 1 if child(args.variants, args.out) else 0
    for name in args.variants:
        variant_source(name)  # every edit applies
    t0 = time.time()
    names = build(args.variants)
    print(json.dumps({"built_in_s": time.time() - t0}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    try:
        r = subprocess.run([sys.executable, __file__, "--child", "--out",
                            args.out, *names], timeout=args.timeout)
    except subprocess.TimeoutExpired:
        print("the checks or timings did not finish: a variant hangs")
        return 1
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
