"""Analytic per-device memory + collective-traffic model per dry-run cell.

XLA's CPU backend reports `temp_size` without buffer reuse (a several-x
over-count) and its text-level while-loop structure resists reliable trip
scaling (the "wide" loop transform nests synthetic regions). Since *we*
own every sharding decision, the deterministic way to get the roofline's
collective term and the fits-in-HBM proof is to derive both from the
sharding policy itself — the same approach production frameworks
(MaxText) use. The HLO-parsed numbers stay in the record as bounds, and
the collective *op mix* from the HLO cross-checks which transfers exist.

Wire convention: ring all-reduce counts 2×(n-1)/n ≈ 2× the tensor,
all-gather/reduce-scatter (n-1)/n ≈ 1×, all-to-all ≈ 1× ((n-1)/n of the
tensor leaves the chip).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSuite

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class MeshView:
    n_devices: int
    model: int
    dp: int  # data (× pod)
    mode: str = "tp"  # "tp" | "fsdp_sp" (see ShardingPolicy)


def _params_bytes(cfg: ModelConfig) -> float:
    w = 1.02 if cfg.weight_dtype == "int8" else BF16
    return cfg.param_count() * w


@dataclass
class CellModel:
    """Analytic memory + comm for one (arch × shape × mesh) cell.

    ``params_local_bytes`` — exact per-device parameter bytes computed
    from the actual PartitionSpecs (see ``dryrun._sharded_param_bytes``);
    falls back to the model-axis-only upper bound when absent.
    """

    cfg: ModelConfig
    shape: ShapeSuite
    mesh: MeshView
    microbatches: int = 1
    params_local_bytes: float = 0.0

    # -- sizes ------------------------------------------------------------
    @property
    def tokens_local(self) -> int:
        return self.shape.global_batch * self.shape.seq_len // self.mesh.dp

    @property
    def act_bytes_mb(self) -> float:
        """One residual-stream tensor per microbatch per device."""
        return self.tokens_local // self.microbatches * self.cfg.d_model * BF16

    def memory_gb(self) -> Dict[str, float]:
        cfg, mesh = self.cfg, self.mesh
        p = self.params_local_bytes or _params_bytes(cfg) / mesh.model
        out = {"params": p}
        if self.shape.kind == "train":
            out["grads_fp32"] = p * 2  # fp32 accumulator of bf16 params
            out["opt_mv"] = p * 4  # m+v fp32
            # remat scan saves one (B_mb, S, d) per block + ~4 live tensors
            out["saved_residuals"] = self.act_bytes_mb * cfg.n_blocks
            out["live_working_set"] = self.act_bytes_mb * 8
        elif self.shape.kind == "prefill":
            out["activations"] = (
                self.tokens_local * cfg.d_model * BF16 * 4
            )
            out["cache_out"] = self._cache_bytes()
        else:
            out["cache"] = self._cache_bytes()
            out["activations"] = (
                self.shape.global_batch * cfg.d_model * BF16 * 8
            )
        out = {k: v / 1e9 for k, v in out.items()}
        out["total"] = sum(out.values())
        return out

    def _cache_bytes(self) -> float:
        """Decode cache per device. The cache_pspecs rules shard the
        (batch × seq) plane over (dp × model) — or seq over everything
        when batch=1 — so the per-device share is total / shards."""
        cfg, mesh, sh = self.cfg, self.mesh, self.shape
        if cfg.kv_dtype == "int8":
            kv_tok = (
                2 * cfg.kv_dim + 2 * cfg.n_kv_heads * F32
            ) * cfg.n_attn_layers
        else:
            kv_tok = 2 * cfg.kv_dim * cfg.n_attn_layers * BF16
        total_kv = kv_tok * sh.global_batch * sh.seq_len
        ssm = 0.0
        if cfg.has_mamba:
            m = cfg.mamba
            n_m = sum(
                1 for s in cfg.block_pattern if s.mixer == "mamba"
            ) * cfg.n_blocks
            per_req = (
                m.n_heads(cfg.d_model) * m.head_dim * m.d_state * F32
                + (m.d_inner(cfg.d_model) + 2 * m.d_state)
                * (m.d_conv - 1) * BF16
            )
            ssm = per_req * sh.global_batch * n_m
        if sh.global_batch % mesh.dp == 0:
            kv_shards = mesh.dp * mesh.model  # batch × seq sharding
            ssm_shards = mesh.dp * mesh.model  # batch × heads
        elif sh.seq_len % mesh.n_devices == 0:
            kv_shards = mesh.n_devices  # seq over everything (batch=1)
            ssm_shards = mesh.model  # heads only
        else:
            kv_shards = ssm_shards = 1
        return total_kv / kv_shards + ssm / ssm_shards

    # -- collectives --------------------------------------------------------
    def comm_bytes(self) -> Dict[str, float]:
        """Per-device wire bytes for ONE step, by source."""
        cfg, mesh, sh = self.cfg, self.mesh, self.shape
        out: Dict[str, float] = {}
        tp = mesh.model
        n_moe = sum(
            1 for s in cfg.block_pattern if s.ffn == "moe"
        ) * cfg.n_blocks
        n_mix = sum(
            1 for s in cfg.block_pattern if s.mixer != "none"
        ) * cfg.n_blocks
        n_ffn = sum(
            1 for s in cfg.block_pattern if s.ffn != "none"
        ) * cfg.n_blocks

        fsdp_sp = mesh.mode == "fsdp_sp"
        if sh.kind == "train":
            if fsdp_sp:
                # per-layer weight all-gather × {fwd, bwd, remat-refwd};
                # each device receives ~the full (non-MoE) weights once
                # per pass, grads reduce-scatter once.
                dense_p = _params_bytes(cfg) - (
                    n_moe * cfg.moe.num_experts
                    * 3 * cfg.d_model * cfg.moe.d_ff_expert * BF16
                    if cfg.moe else 0.0
                )
                out["weight_allgather"] = 3.0 * dense_p
                out["grad_reduce_scatter"] = dense_p
                # attention K/V all-gather over the seq-sharded axis
                if cfg.has_attention:
                    kv = (
                        self.tokens_local // self.microbatches
                        * 2 * cfg.kv_dim * BF16
                    )
                    out["attn_kv_allgather"] = (
                        3.0 * kv * cfg.n_attn_layers * self.microbatches
                    )
            else:
                # Megatron TP: one activation all-reduce per sub-layer
                # (mixer out + ffn out) in fwd, bwd, and the remat
                # re-forward ⇒ 3 passes; ring all-reduce ≈ 2×(n-1)/n.
                act = self.act_bytes_mb
                n_ar = 3.0 * (n_mix + n_ffn) * self.microbatches
                out["tp_allreduce"] = n_ar * act * 2.0 * (tp - 1) / tp
                p_local = _params_bytes(cfg) / tp
                if mesh.dp > 1:
                    out["dp_grad_sync"] = (
                        2.0 * p_local * (mesh.dp - 1) / mesh.dp
                    )
        else:
            act_tok = (
                self.tokens_local
                if sh.kind == "prefill"
                else sh.global_batch // (
                    mesh.dp if sh.global_batch % mesh.dp == 0 else 1
                )
            )
            act = act_tok * cfg.d_model * BF16
            if fsdp_sp and sh.kind == "prefill":
                dense_p = _params_bytes(cfg) - (
                    n_moe * cfg.moe.num_experts
                    * 3 * cfg.d_model * cfg.moe.d_ff_expert * BF16
                    if cfg.moe else 0.0
                )
                out["weight_allgather"] = dense_p
                if cfg.has_attention:
                    kv = act_tok * 2 * cfg.kv_dim * BF16
                    out["attn_kv_allgather"] = kv * cfg.n_attn_layers
            else:
                out["tp_allreduce"] = (
                    (n_mix + n_ffn) * act * 2.0 * (tp - 1) / tp
                )
                # FSDP-resident weight fraction must gather every step
                if self.params_local_bytes:
                    gathered = max(
                        0.0,
                        _params_bytes(cfg) / tp - self.params_local_bytes,
                    )
                    if gathered > 1e6:
                        out["weight_allgather"] = gathered
            if sh.kind == "decode" and cfg.has_attention:
                # seq-sharded cache ⇒ per-layer partial-softmax combine:
                # (B_loc, Hq, Dh) partials + (B_loc, Hq) stats, all-reduced
                b_loc = act_tok
                part = b_loc * cfg.q_dim * F32 + 2 * b_loc * cfg.n_heads * F32
                out["attn_partial_combine"] = (
                    2.0 * part * cfg.n_attn_layers * (tp - 1) / tp
                )
        if n_moe:
            # token dispatch+combine all-to-all (fwd; ×3 with bwd in train)
            toks = self.tokens_local // self.microbatches if sh.kind == \
                "train" else (
                    self.tokens_local if sh.kind == "prefill"
                    else sh.global_batch
                )
            elem = 1.02 if (cfg.moe and cfg.moe.dispatch_dtype == "int8") \
                else BF16
            a2a = toks * cfg.d_model * elem * cfg.moe.top_k
            mult = 3.0 * self.microbatches if sh.kind == "train" else 2.0
            out["moe_all_to_all"] = (
                a2a * n_moe * mult * (tp - 1) / tp
            )
        out["total"] = sum(out.values())
        return out
