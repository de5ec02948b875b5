"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE. [arXiv:2403.19887; hf]

Super-block of 8 layers: attention at index 4 (1 attn : 7 mamba), MoE replacing
the MLP every other layer (e=2). Jamba v0.1 uses Mamba-1 mixers; we implement
the Mamba2/SSD form as the TPU-native equivalent (DESIGN.md §2) with the same
d_inner/d_conv; ssm state follows the SSD parameterization.
"""
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig, MoEConfig

_M = "mamba"
_A = "attn"

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=(
        LayerSpec(mixer=_M, ffn="mlp"),
        LayerSpec(mixer=_M, ffn="moe"),
        LayerSpec(mixer=_M, ffn="mlp"),
        LayerSpec(mixer=_M, ffn="moe"),
        LayerSpec(mixer=_A, ffn="mlp"),
        LayerSpec(mixer=_M, ffn="moe"),
        LayerSpec(mixer=_M, ffn="mlp"),
        LayerSpec(mixer=_M, ffn="moe"),
    ),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    use_rope=False,  # jamba uses no positional encoding (mamba provides order)
    sub_quadratic=True,  # only 4/32 layers are attention => long_500k runs
    notes="1:7 attn:mamba, MoE every 2nd layer (16e top-2).",
)
