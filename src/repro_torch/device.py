"""Device choice for the port's entry points: CUDA unless asked otherwise,
and the analysis mode in which the card is traced, not touched."""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# The device a trace runs on: meta tensors have shapes, dtypes and
# storages but no data.  (A fake CUDA tensor would do, but a build of
# PyTorch without CUDA links no device guard for it: indexing one raises
# and autograd aborts the process.)
ANALYSIS_DEVICE = torch.device("meta")

_ANALYSIS: ContextVar[bool] = ContextVar("repro_torch_analysis_mode",
                                         default=False)


@contextlib.contextmanager
def analysis_mode():
    """Trace, don't touch the device (the counterpart of the reference's
    ``analysis_mode``, ``repro/models/layers.py:34-47``).  Inside, a
    tensor on :data:`ANALYSIS_DEVICE` stands for one on the card: the
    model takes its card paths on it and each kernel wrapper returns
    outputs of its launch's shapes and dtypes, counts the launch and
    reports its cost (:func:`repro_torch.kernels.kernel_costs`) without
    building or calling the kernel."""
    token = _ANALYSIS.set(True)
    try:
        yield
    finally:
        _ANALYSIS.reset(token)


def in_analysis_mode() -> bool:
    return _ANALYSIS.get()


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is the card's: a CUDA tensor, or under
    :func:`analysis_mode` a tensor on :data:`ANALYSIS_DEVICE`."""
    return t.is_cuda or (t.is_meta and _ANALYSIS.get())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  With no card the caller must say
    ``device="cpu"``: an entry point never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
