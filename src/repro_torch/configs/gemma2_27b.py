"""gemma2-27b — local+global alternating attention, logit softcaps. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    # super-block of 2: one local (sliding-window 4096) then one global layer
    block_pattern=(
        LayerSpec(mixer="attn", ffn="mlp", window=4096),
        LayerSpec(mixer="attn", ffn="mlp"),
    ),
    tie_embeddings=True,
    rope_theta=10000.0,
    logit_softcap=30.0,
    attn_softcap=50.0,
    act="gelu",  # GeGLU
    notes=(
        "Alternating local(4096)/global attention; final-logit softcap 30, "
        "attention softcap 50. Half the layers are full attention, so the "
        "arch is NOT sub-quadratic end-to-end (long_500k skipped)."
    ),
)
