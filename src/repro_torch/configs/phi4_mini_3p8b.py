"""phi4-mini-3.8b — dense decoder, RoPE + SwiGLU + GQA. [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    tie_embeddings=True,
    rope_theta=10000.0,
    act="silu",
    notes="RoPE SwiGLU GQA; phi4-mini ties input/output embeddings.",
)
