"""chameleon-34b — early-fusion VLM, VQ image tokens in the shared vocab.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    qk_norm=True,  # chameleon stabilizes with query/key norm
    rope_theta=10000.0,
    act="silu",
    notes=(
        "Early fusion: images are VQ-tokenized into the shared 65536 vocab, "
        "so the backbone consumes plain token ids. The VQ tokenizer is the "
        "modality frontend STUB: input_specs() provides pre-tokenized ids."
    ),
)
