"""mamba2-2.7b — attention-free SSM with SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,  # Mamba2 blocks have no separate FFN
    vocab_size=50280,
    block_pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    use_rope=False,
    sub_quadratic=True,  # O(1) state per request => long_500k runs
    notes="SSD; d_inner=5120, 80 ssm heads of dim 64, state 128.",
)
