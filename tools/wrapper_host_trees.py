#!/usr/bin/env python3
"""The kernel wrappers' host cost (``host_ms``: the enqueue time of one
call, measured behind a sleeping kernel by ``chip_smoke.queued_ms``) for
several source trees, one after another on the same card: compare two
versions of the wrappers' Python within one call.

Each tree is a checkout of the repo (the working tree, or an older
commit unpacked with ``git archive``).  Each run is a process of its own
that imports that tree's ``chip_smoke`` and ``repro_torch``, builds its
kernels and times ``REPS`` rounds of three of the kernel phase's timed
rows at phase 4's shapes, in bf16: ``flash_prefill`` (B=1 S=512 32/8 Dh
128, two thirds of the keys valid), ``ring_decode`` (B=8 C=1024) and
``paged_decode`` (T=1 over the kernel phase's ragged lengths).  Each row
prints as one JSON line, and the whole output goes to
``<out>/wrapper_host_<i>.log``.

    python3 tools/wrapper_host_trees.py [--out chiprun_out] TREE [TREE ...]

e.g. ``build/parent . . build/parent`` for parent, change, change,
parent.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 5
LLAMA = dict(Hq=32, Hkv=8, Dh=128)


def one(tree: Path) -> None:
    """The rows of ``tree``, in this process."""
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}: {cs.__file__}", flush=True)
    print(cs.card_identity(), flush=True)
    from repro_torch.kernels import _build

    _build.build()
    lengths = [1024, 700, 513, 512, 300, 17, cs.SPEC_K + 2, 0]
    cases = {
        "flash_prefill": lambda: cs.flash_case(
            torch, F, 1, 512, dtype="bfloat16", kv_frac=2 / 3, window=None,
            softcap=None, timed=True, **LLAMA),
        "ring_decode": lambda: cs.decode_case(
            torch, F, cs.SLOTS, cs.MAX_LEN, dtype="bfloat16", window=None,
            softcap=None, timed=True, **LLAMA),
        "paged_decode": lambda: cs.paged_case(
            torch, F, cs.SLOTS, 1, lengths=lengths, dtype="bfloat16",
            window=None, softcap=None, timed=True, **LLAMA),
    }
    got = {name: [] for name in cases}
    for _ in range(REPS):
        for name, case in cases.items():
            row = case()
            got[name].append((row["host_ms"], row["device_ms"]))
    for name, rows in got.items():
        host = [h for h, _ in rows]
        print("ROW " + json.dumps({
            "tree": str(tree), "kernel": name, "host_ms": host,
            "host_ms_median": statistics.median(host),
            "device_ms": [d for _, d in rows]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out"))
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        one(args.one.resolve())
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    rc = 0
    for i, tree in enumerate(args.trees, 1):
        log = args.out / f"wrapper_host_{i}.log"
        with open(log, "w") as f:
            code = subprocess.run(
                [sys.executable, __file__, "--one", str(tree)],
                stdout=f, stderr=subprocess.STDOUT).returncode
        print(f"run {i}: tree {tree}, exit {code}", flush=True)
        for line in log.read_text().splitlines():
            if line.startswith(("ROW ", "NVIDIA")) or "Error" in line:
                print(line[:700], flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
