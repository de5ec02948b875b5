"""minicpm-2b — llama-like dense (MHA: 36 kv heads), WSD schedule. [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    tie_embeddings=True,
    rope_theta=10000.0,
    act="silu",
    notes=(
        "MHA (kv=36). Trained with the WSD (warmup-stable-decay) schedule, "
        "implemented in repro_torch.training.optimizer. MiniCPM's mup-style "
        "residual scaling is omitted (initialization detail, not serving-"
        "relevant)."
    ),
)
