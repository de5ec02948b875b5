"""Carry JAX model weights into the port, leaf for leaf.

The caller turns a JAX param tree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module imports no JAX.
The tree keeps its layout, including the stacked ``params["blocks"]``
leaves with their leading ``n_blocks`` axis.  On a mesh slice,
:func:`shard_params` (the local-shard step of
:func:`repro_torch.distributed.sharding.place_serving_state`) then cuts
the full tree into this rank's shards, which compute what the JAX model
computes.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import shard_params  # noqa: F401


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    arr = np.array(x, copy=True, order="C")  # writable, owned
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# Leaves the JAX model keeps in float32 whatever the model dtype (the
# Mamba2 mixer's decay, step bias and skip: repro/models/model.py:57-84;
# an int8 weight's per-channel scale: repro/models/model.py:193-196).
FLOAT32_LEAVES = frozenset({"A_log", "dt_bias", "D", "sc"})


def params_from_jax(np_tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The port's params from a numpy copy of a JAX param tree.
    ``dtype`` casts the floating-point leaves, except those named in
    ``FLOAT32_LEAVES``; integer leaves keep theirs, so a quantized
    ``{"q8", "sc"}`` leaf crosses as int8 codes and float32 scales."""
    dev = resolve_device(device)

    def conv(x, name=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        t = _to_tensor(np.asarray(x))
        if dtype is not None and t.is_floating_point() \
                and name not in FLOAT32_LEAVES:
            t = t.to(dtype)
        return t.to(dev)

    return conv(np_tree)
