"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with :mod:`ctypes`.  Nothing includes PyTorch's headers, so a build
takes seconds.  Libraries go to ``build/repro_torch_kernels/`` at the
root of the checkout, named by a hash of source and flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing here runs at
import: the first :func:`load` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("flash_prefill", "flash_backward", "ring_decode",
           "paged_attention", "ssd_scan", "ssd_backward")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the "
        "CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: (seconds,
    compiler output)}`` for the sources it compiled (``ptxas -v`` lists
    registers, shared memory and spills).  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, time.perf_counter(), tmp, out)
    done: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, t0, tmp, out) in started.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
HEAD_DIMS = (16, 64, 128)  # reduced configs, minicpm, llama and most others
# the prefill kernel and its backward also take hubert-xlarge's 80, and
# in float32 the demo configs' 32 (examples/train_small_torch.py); the
# decode kernels (ring_decode.cu, paged_attention.cu) instantiate
# HEAD_DIMS only
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128)
FLASH_BF16_HEAD_DIMS = (16, 64, 80, 128)


def dtype_code(t) -> int:
    """The C entry points' dtype code of a tensor (0 f32, 1 bf16)."""
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def check_operand(name: str, t, device, align: int = 16) -> None:
    """A kernel operand must be on the kernel's device, contiguous, and
    aligned (the kernels load q/k/v as 16-byte vectors)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
