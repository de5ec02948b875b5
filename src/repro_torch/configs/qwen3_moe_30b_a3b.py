"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, GQA kv=4, qk-norm. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,  # every FFN is MoE
    vocab_size=151936,
    block_pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    notes="128 experts, top-8 routing, 768 expert hidden dim (~3B active).",
)
