"""Architecture registry of the port: the configs its model path serves."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from repro_torch.configs import (
    chameleon_34b,
    command_r_plus_104b,
    llama31_8b,
    mamba2_2p7b,
    minicpm_2b,
    ministral_3b,
    phi4_mini_3p8b,
    qwen3_32b,
)

# The assigned architectures the port serves so far: the plain dense
# family and mamba2.  gemma2 (sliding attention), the MoE configs
# (qwen3-moe, dbrx), hubert (encoder, head dim 80) and jamba (hybrid MoE)
# join with their layers (ROADMAP queue 1, item 7).
ASSIGNED = {
    "phi4-mini-3.8b": phi4_mini_3p8b.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
}

# The paper's own evaluation models (benchmarks reproducing its figures).
PAPER_MODELS = {
    "llama-3.1-8b": llama31_8b.CONFIG,
    "qwen3-32b": qwen3_32b.CONFIG,
    "ministral-3b": ministral_3b.CONFIG,
}

REGISTRY = {**ASSIGNED, **PAPER_MODELS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]
