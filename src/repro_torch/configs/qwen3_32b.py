"""qwen3-32b — paper eval model (TP-2 on A100; GH200 study). [arXiv:2505.09388]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    notes="Paper eval model; peak 36.3% energy saving config (ShareGPT RPS 20).",
)
