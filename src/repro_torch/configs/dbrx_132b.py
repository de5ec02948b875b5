"""dbrx-132b — fine-grained 16-expert top-4 MoE. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100352,
    block_pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    rope_theta=500_000.0,
    act="silu",
    notes="16 experts top-4 (fine-grained); GQA kv=8.",
)
