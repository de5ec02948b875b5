"""Model/architecture configuration system.

A model is a sequence of identical *super-blocks* (so the forward pass can
``lax.scan`` over stacked per-block parameters even when the layer pattern is
heterogeneous, e.g. gemma2's local/global alternation or jamba's 1:7
mamba:attention interleave). Each super-block applies ``block_pattern`` in
order; the pattern repeats ``n_layers // len(block_pattern)`` times.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer / sub-module specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a super-block."""

    mixer: str  # "attn" | "mamba" | "none"
    ffn: str  # "mlp" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size for local attention


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int  # hidden dim of each expert FFN
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    dispatch_dtype: Optional[str] = None  # "int8" => quantized all-to-all


@dataclass(frozen=True)
class MambaConfig:
    """Mamba2 (SSD, state-space duality) mixer configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # dense FFN hidden dim (0 for pure-SSM / pure-MoE FFN archs)
    vocab_size: int
    block_pattern: Tuple[LayerSpec, ...]
    causal: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False
    logit_softcap: Optional[float] = None  # gemma2: 30.0
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    norm_eps: float = 1e-6
    act: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)
    embed_inputs: bool = True  # False => frontend stub provides embeddings
    dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"  # "int8" => quantized decode cache (+scales)
    weight_dtype: str = "bfloat16"  # "int8" => quantized serving weights
    # Sub-quadratic statement for the long_500k shape gate.
    sub_quadratic: bool = False
    notes: str = ""

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.block_pattern)}"
        )
        if any(s.ffn == "moe" for s in self.block_pattern):
            assert self.moe is not None
        if any(s.mixer == "mamba" for s in self.block_pattern):
            assert self.mamba is not None

    # -- structure ----------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return any(s.mixer == "attn" for s in self.block_pattern)

    @property
    def has_mamba(self) -> bool:
        return any(s.mixer == "mamba" for s in self.block_pattern)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def attn_layers_per_block(self) -> int:
        return sum(1 for s in self.block_pattern if s.mixer == "attn")

    @property
    def n_attn_layers(self) -> int:
        return self.attn_layers_per_block * self.n_blocks

    # -- parameter accounting -----------------------------------------------
    def _layer_params(self, spec: LayerSpec) -> Tuple[int, int]:
        """(total, active) params of one layer (norms excluded, negligible)."""
        d = self.d_model
        total = active = 0
        if spec.mixer == "attn":
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            total += p
            active += p
        elif spec.mixer == "mamba":
            m = self.mamba
            di = m.d_inner(d)
            nh = m.n_heads(d)
            # in_proj -> [z, x, B, C, dt], out_proj
            in_p = d * (2 * di + 2 * m.d_state + nh)
            conv = (di + 2 * m.d_state) * m.d_conv
            out_p = di * d
            p = in_p + conv + out_p + nh  # + dt bias / A_log / D ~ nh each
            total += p
            active += p
        if spec.ffn == "mlp":
            p = 3 * d * self.d_ff
            total += p
            active += p
        elif spec.ffn == "moe":
            e = self.moe
            per_e = 3 * d * e.d_ff_expert
            total += e.num_experts * per_e + d * e.num_experts
            active += e.top_k * per_e + d * e.num_experts
        return total, active

    def param_count(self) -> int:
        per_block = sum(self._layer_params(s)[0] for s in self.block_pattern)
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        if not self.embed_inputs:
            emb = self.vocab_size * self.d_model  # output head only
        return per_block * self.n_blocks + emb

    def active_param_count(self) -> int:
        per_block = sum(self._layer_params(s)[1] for s in self.block_pattern)
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        if not self.embed_inputs:
            emb = self.vocab_size * self.d_model
        return per_block * self.n_blocks + emb

    # -- reduced config for CPU smoke tests ----------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config: one super-block, small dims."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=len(self.block_pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=257,
        )
        if self.moe is not None:
            # generous capacity: reduced configs are correctness vehicles
            # (prefill/decode-vs-forward equivalence needs no drops)
            kw["moe"] = MoEConfig(
                num_experts=4,
                top_k=min(2, self.moe.top_k),
                d_ff_expert=32,
                capacity_factor=4.0,
            )
        if self.mamba is not None:
            kw["mamba"] = MambaConfig(
                d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32
            )
        return dataclasses.replace(self, **kw)
