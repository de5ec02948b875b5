"""Carry JAX model weights into the port, leaf for leaf.

The caller turns a JAX param tree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module imports no JAX.
The tree keeps its layout, including the stacked ``params["blocks"]``
leaves with their leading ``n_blocks`` axis.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    arr = np.array(x, copy=True, order="C")  # writable, owned
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The port's params from a numpy copy of a JAX param tree.
    ``dtype`` casts the floating-point leaves; integer leaves keep theirs."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = _to_tensor(np.asarray(x))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return conv(np_tree)
