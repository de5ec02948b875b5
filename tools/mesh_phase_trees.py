#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 9 (llama-3.1-8b on a tp=2 slice of two ranks
sharing the card, eager) for several source trees, one after another on
the same card: compare two versions of the mesh path within one call.

Each tree is a checkout of the repo (the working tree, or an older
commit unpacked with ``git archive``).  Each run is a process of its own
that imports that tree's ``chip_smoke`` and ``repro_torch``, builds its
kernels, fits the llama predictor and calls ``mesh_phase``; its whole
output goes to ``<out>/mesh_phase_<i>.log`` and its serve and collective
lines to stdout.

    python3 tools/mesh_phase_trees.py [--out chiprun_out] TREE [TREE ...]

e.g. ``build/parent . . build/parent`` for parent, change, change,
parent.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

KEEP = re.compile(r"^serve\[mesh|^mesh collectives|^mesh: |^PHASE9 |"
                  r"Error|error")


def one(tree: Path) -> None:
    """Phase 9 of ``tree``, in this process."""
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}: {cs.__file__}", flush=True)
    print(cs.card_identity(), flush=True)
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.kernels import _build
    from repro_torch.serving.cluster import build_predictor

    _build.build()
    pred = build_predictor(REGISTRY["llama-3.1-8b"], A100,
                           A100.freq_levels_2, kv_cap=400_000,
                           spec_k=cs.SPEC_K)
    t0 = time.perf_counter()
    cs.mesh_phase(torch, pred)
    print(f"PHASE9 {time.perf_counter() - t0:.1f} s", flush=True)


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
        log = args.out / f"mesh_phase_{i}.log"
        with open(log, "w") as f:
            code = subprocess.run(
                [sys.executable, __file__, "--one", str(tree)],
                stdout=f, stderr=subprocess.STDOUT).returncode
        print(f"run {i}: tree {tree}, exit {code}", flush=True)
        for line in log.read_text().splitlines():
            if KEEP.search(line):
                print(line[:700], flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
