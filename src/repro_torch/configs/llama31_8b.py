"""llama-3.1-8b — the paper's primary evaluation model (Fig. 1, 5, 16-21). [arXiv:2407.21783]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    rope_theta=500_000.0,
    act="silu",
    notes="Paper's main eval model (LLaMA-3.1-8B on A100, SGLang).",
)
