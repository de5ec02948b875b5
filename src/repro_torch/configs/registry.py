"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from repro_torch.configs import (
    chameleon_34b,
    command_r_plus_104b,
    dbrx_132b,
    gemma2_27b,
    hubert_xlarge,
    jamba_v0p1_52b,
    llama31_8b,
    mamba2_2p7b,
    minicpm_2b,
    ministral_3b,
    phi4_mini_3p8b,
    qwen3_32b,
    qwen3_moe_30b_a3b,
)

# The 10 assigned architectures (dry-run / roofline matrix).
ASSIGNED = {
    "phi4-mini-3.8b": phi4_mini_3p8b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "minicpm-2b": minicpm_2b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
    "jamba-v0.1-52b": jamba_v0p1_52b.CONFIG,
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
