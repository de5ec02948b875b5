"""hubert-xlarge — encoder-only audio backbone (w2v2 arch). [arXiv:2106.07447; unverified]

The CNN waveform frontend is a STUB: input_specs() provides precomputed frame
embeddings of shape (batch, frames, d_model). The backbone predicts one of 504
cluster targets per frame (HuBERT masked-prediction objective).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    causal=False,  # bidirectional encoder
    use_rope=False,  # positions come from the (stubbed) conv frontend
    embed_inputs=False,  # frontend stub provides embeddings
    act="gelu",
    notes=(
        "Encoder-only: no decode phase exists, so decode_32k/long_500k shapes "
        "are skipped and EcoRoute's decode state space is inapplicable "
        "(DESIGN.md §Arch-applicability)."
    ),
)
