"""command-r-plus-104b — large dense, GQA, no-bias. [hf:CohereForAI; unverified]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    tie_embeddings=True,
    rope_theta=10000.0,
    act="silu",
    notes=(
        "No biases anywhere (matches this repo's default). The HF model uses "
        "a parallel attention+FFN block; we use the standard sequential "
        "block (same FLOPs/params; noted in DESIGN.md)."
    ),
)
