#!/usr/bin/env python
"""Variants of the port's SSD backward (bf16 body), built and timed side
by side on one card, to see where the sub-chunk kernel's time goes.

Each variant is the committed ``src/repro_torch/kernels/csrc/
ssd_backward.cu`` with a few text edits, compiled by its own ``nvcc``
(all started together):

* ``as_built``: no edit;
* ``no_dx``: the sub-chunk kernel computes no dx (intra and state terms);
* ``no_qr``: no q = dy S_in and r = x dS_out products;
* ``no_conversion``: the state tiles are not split into bf16 parts;
* ``no_head_end``: no head's end (D, G, W, u, v, the folds into dB and
  dC); q and r are then dead code, so their products go too;
* ``phases``: clocks per phase of one block (cycles a warp): the wait
  and barrier at a tile's top, the work before the conversion (staging,
  dx hand-over, a head's start), the conversion, the barrier after it,
  the products, a head's end, the group's final products.

Only ``as_built`` computes the backward; the others time what is left.
``as_built`` is held against the plain backward at a small shape first.
Each variant is timed at mamba2-2.7b's training shape (B=4, S=1,024,
H=80, P=64, N=128; x, B and C slices of one tensor) with its launches
queued behind a sleep (device time), in order and again in reverse, with
the profiler's split by kernel and ``ptxas -v``'s registers and spills.

Run where ``nvcc`` and the card are::

    python tools/ssd_backward_variants.py [--out FILE] [VARIANT ...]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/ssd_backward_variants"
SHAPE = dict(B=4, S=1024, H=80, P=64, N=128)
PHASES = ("top barrier", "before conversion", "conversion",
          "barrier after it", "products", "head end", "group end")


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant edit does not apply: {old[:60]!r}")
    return src.replace(old, new, 1)


def _phases(src: str) -> str:
    """Clocks at each phase boundary of the sub-chunk kernel; block
    (7, 3, 1) writes each warp's cycles into the dB partial scratch."""
    src = _edit(src, "  for (int u = 0; u < units; ++u) {\n",
                "  long long tacc[8] = {}, tk = clock64();\n"
                "  const long long t0 = tk;\n"
                "  auto tick = [&](int k) {\n"
                "    const long long n = clock64();\n"
                "    tacc[k] += n - tk;\n    tk = n;\n  };\n"
                "  for (int u = 0; u < units; ++u) {\n")
    top = "    __syncthreads();  // unit u's tiles are in; unit u - 1 is done\n"
    src = _edit(src, top, top + "    tick(0);\n")
    conv = "    {  // this unit's S_in and dS_out rows into bf16 parts\n"
    src = _edit(src, conv, "    tick(1);\n" + conv)
    src = _edit(src, "    __syncthreads();  // the parts are visible\n",
                "    tick(2);\n    __syncthreads();  // the parts are visible\n"
                "    tick(3);\n")
    src = _edit(src, "    if (pt != npt - 1) continue;\n",
                "    tick(4);\n    if (pt != npt - 1) continue;\n")
    src = _edit(src, "    if (lane == 0) red[warp] = sdot;\n",
                "    if (lane == 0) red[warp] = sdot;\n    tick(5);\n")
    src = _edit(src, "  if (!n_on) return;\n", "")
    return _edit(
        src, "#pragma unroll\n  for (int hr = 0; hr < 2; ++hr) {\n"
             "    const int i = hr ? i1 : i0;\n    if (i >= rows) continue;\n",
        "  tick(6);\n"
        "  if (lane == 0 && blockIdx.x == 7 && blockIdx.y == 3 &&\n"
        "      blockIdx.z == 1) {\n"
        "    for (int k = 0; k < 7; ++k)\n"
        "      p.dBp[warp * 8 + k] = (float)tacc[k];\n"
        "    p.dBp[warp * 8 + 7] = (float)(clock64() - t0);\n  }\n"
        "#pragma unroll\n  for (int hr = 0; hr < 2; ++hr) {\n"
        "    const int i = hr ? i1 : i0;\n    if (i >= rows) continue;\n")


VARIANTS = {
    "as_built": lambda s: s,
    "no_dx": lambda s: _edit(
        s, "    {  // dx_j = dt_j sum_{i>=j}", "    if (false) {  // dx_j"),
    "no_qr": lambda s: _edit(
        s, "    if (n_on) {  // q += dy[:, tile] S_in[tile]",
        "    if (false) {  // q +="),
    "no_conversion": lambda s: _edit(
        s, "      for (int i = tid; i < PT * N / 2; i += CH_THREADS) {",
        "      for (int i = tid; i < 0; i += CH_THREADS) {"),
    "no_head_end": lambda s: _edit(
        s, "    if (pt != npt - 1) continue;\n", "    continue;\n"),
    "phases": _phases,
}


def build(names):
    """{variant: (ctypes function, ptxas rows of the sub-chunk kernel and
    the walk at N = 128)}, one nvcc per variant, all started together."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    base = (CSRC / "ssd_backward.cu").read_text()
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(VARIANTS[name](base))
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas = {}
        for block in log.split("Compiling entry function ")[1:]:
            kernel = re.match(r"'(\w+)'", block).group(1)
            if "ILi128E" not in kernel or "_tc_kernel" not in kernel:
                continue
            used = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            ptxas["chunk" if "chunk" in kernel else "walk"] = {
                "registers": int(used.group(1)),
                "spill_store_bytes": int(spill.group(1))}
        fn = ctypes.CDLL(str(lib)).repro_ssd_backward
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        out[name] = (fn, ptxas)
    return out


def inputs(torch, B, S, H, P, N, seed=0):
    """bf16 inputs as the model passes them (x, B, C slices of one
    tensor), dt and A under a softplus / log-normal law, the training
    forward's states, and the scratch the wrapper would allocate."""
    from repro_torch.kernels.ssd import ops as sops

    g = torch.Generator(device="cuda").manual_seed(seed)
    di = H * P
    xbc = torch.randn((B, S, di + 2 * N), generator=g, device="cuda")
    xbc[..., di:] *= 0.3
    xbc = xbc.bfloat16()
    x, Bm, Cm = (xbc[..., :di].reshape(B, S, H, P), xbc[..., di: di + N],
                 xbc[..., di + N:])
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    dy = torch.randn((B, S, H, P), generator=g, device="cuda").bfloat16()
    states = torch.empty(sops.states_shape(B, S, H, P, N), device="cuda")
    sops._launch(x, dt, A, Bm, Cm, states)
    scratch = [torch.empty(s, device="cuda")
               for s in sops.backward_scratch_shapes(B, S, H, P, N, 1)]
    return x, dt, A, Bm, Cm, dy, states, scratch


def caller(torch, fn, ins):
    x, dt, A, Bm, Cm, dy, states, scratch = ins
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    outs = (torch.empty_like(dy), torch.empty_like(dt), torch.empty_like(A),
            torch.empty((B, S, N), dtype=Bm.dtype, device="cuda"),
            torch.empty((B, S, N), dtype=Cm.dtype, device="cuda"))

    def call():
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), dy.data_ptr(), None, states.data_ptr(),
                 *(t.data_ptr() for t in scratch),
                 *(t.data_ptr() for t in outs), x.stride(0), x.stride(1),
                 Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 B, S, H, P, N, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return outs
    return call


def held(torch, fn):
    """The as-built variant against the plain backward at a small shape:
    each gradient's error relative to its largest magnitude."""
    from repro_torch.kernels.ssd.ref import ssd_backward_ref

    ins = inputs(torch, 2, 200, 11, 64, 128, seed=1)
    got = caller(torch, fn, ins)()
    want = ssd_backward_ref(*ins[:6])
    torch.cuda.synchronize()
    return [float((a.float() - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lines = [{"card": cs.card_identity(), "shape": SHAPE}]
    built = build(args.variants)
    if "as_built" in built:
        lines.append({"as_built_rel_err_dx_ddt_dA_dB_dC":
                      held(torch, built["as_built"][0])})
    ins = inputs(torch, **SHAPE)
    order = list(built) + list(reversed(built))
    for run, name in enumerate(order):
        fn, ptxas = built[name]
        call = caller(torch, fn, ins)
        dev_ms, _ = cs.queued_ms(torch, call, [()])
        row = {"variant": name, "run": 1 + (run >= len(built)),
               "device_ms": dev_ms, "ptxas": ptxas}
        if run < len(built):
            row["device_ms_by_kernel"] = cs.device_ms_by_kernel(torch, call)
            if name == "phases":
                call()
                torch.cuda.synchronize()
                cyc = ins[7][1].flatten()[:16 * 8].view(16, 8).cpu()
                row["cycles_a_warp"] = {
                    ph: [int(v) for v in cyc[:, k]]
                    for k, ph in enumerate(PHASES)}
                row["block_cycles"] = [int(v) for v in cyc[:, 7]]
        lines.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    print(json.dumps(lines[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
