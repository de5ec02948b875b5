"""Architecture registry of the port: the configs its model path serves."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from repro_torch.configs import llama31_8b

# The paper's main evaluation model; the other configs join with the
# MoE, SSD and windowed-attention layers.
PAPER_MODELS = {
    "llama-3.1-8b": llama31_8b.CONFIG,
}

REGISTRY = dict(PAPER_MODELS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]
