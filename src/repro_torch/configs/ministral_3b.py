"""ministral-3b — paper eval model. Weights are not open; dims approximated
from the Ministraux announcement (marked unverified)."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="ministral-3b",
    family="dense",
    n_layers=26,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=131072,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    rope_theta=100_000.0,
    act="silu",
    notes="Approximate dims (closed weights); used only for paper-figure benchmarks.",
)
