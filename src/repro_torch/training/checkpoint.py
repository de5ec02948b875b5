"""Checkpointing with async write, retention and restore onto a device.

Counterpart of ``repro/training/checkpoint.py``, on the reference's
on-disk layout::

    <dir>/step_<n>/manifest.json   tree structure + shapes + dtypes + meta
    <dir>/step_<n>/arrays.npz      flat leaf arrays, leaf_i in JAX's
                                   flatten order (dict keys sorted)

bf16 leaves are stored as their ``uint16`` bits with the dtype name
``"bfloat16"`` (npz has no bf16), decoded here with torch rather than
``ml_dtypes``; so a checkpoint the JAX package writes restores here and
one written here restores with ``repro.training.restore``.  Writes go to
a temporary directory that is renamed into place, so a preemption
mid-write never corrupts the latest checkpoint.  :func:`restore` gives
CPU tensors; :func:`restore_sharded` puts them on a device (the
reference's elastic re-shard takes a sharding; meshes of the port
train nothing yet, ROADMAP queue 1, item 13).  :class:`CheckpointManager`
adds retention, async (background-thread) saves and a preemption signal
hook.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.training._tree import (
    leaves,
    tree_map,
    treedef_str,
    unflatten,
)

PyTree = Any

def _encode(x) -> tuple:
    """(numpy array, dtype name) of a leaf; a bf16 tensor becomes its
    ``uint16`` bits named ``"bfloat16"``, as the reference stores it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, x.dtype.name


def _decode(x: np.ndarray, dtype_name: str) -> torch.Tensor:
    x = np.array(x, copy=True)
    if x.dtype.name == dtype_name:
        return torch.from_numpy(x)
    if dtype_name == "bfloat16" and x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"cannot decode a {x.dtype} leaf as {dtype_name}")


def save(path: str, tree: PyTree, meta: Optional[dict] = None) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = leaves(tree)
    encoded = [_encode(x) for x in flat]
    arrays = {f"leaf_{i}": e[0] for i, e in enumerate(encoded)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "treedef": treedef_str(tree),
        "n_leaves": len(flat),
        "shapes": [list(e[0].shape) for e in encoded],
        "dtypes": [e[1] for e in encoded],
        "meta": meta or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def restore(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (CPU tensor leaves)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = [
            _decode(z[f"leaf_{i}"], manifest["dtypes"][i])
            for i in range(manifest["n_leaves"])
        ]
    return unflatten(like, flat)


def restore_sharded(path: str, like: PyTree, device: DeviceLike) -> PyTree:
    """:func:`restore` onto ``device``."""
    return tree_map(lambda x: x.to(device), restore(path, like))


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["meta"]


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_write: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._preempted = False

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save/restore -----------------------------------------------------
    def save(self, step: int, tree: PyTree, meta: Optional[dict] = None,
             block: bool = False) -> None:
        # copy to host before handing to the writer thread: the training
        # step updates params and moments in place
        host = tree_map(lambda x: x.detach().to("cpu", copy=True)
                        if isinstance(x, torch.Tensor)
                        else np.array(x, copy=True), tree)

        def work():
            save(self._step_dir(step), host, {**(meta or {}), "step": step})
            self._gc()

        self.wait()
        if self.async_write and not block:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: PyTree, device: DeviceLike = None):
        step = self.latest_step()
        if step is None:
            return None, None
        path = self._step_dir(step)
        if device is not None:
            return restore_sharded(path, like, device), step
        return restore(path, like), step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- preemption hook ----------------------------------------------------
    def install_preemption_hook(self, sig=signal.SIGTERM) -> None:
        def handler(signum, frame):
            self._preempted = True

        signal.signal(sig, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted
