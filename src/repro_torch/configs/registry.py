"""Architecture registry of the port: the configs its model path serves."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from repro_torch.configs import llama31_8b, mamba2_2p7b

# The assigned architectures the port serves so far; MoE, jamba, gemma2,
# hubert and the others join with their layers (ROADMAP queue 1, item 7).
ASSIGNED = {
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
}

# The paper's main evaluation model.
PAPER_MODELS = {
    "llama-3.1-8b": llama31_8b.CONFIG,
}

REGISTRY = {**ASSIGNED, **PAPER_MODELS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]
