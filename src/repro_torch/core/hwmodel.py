"""Roofline-calibrated iteration latency/energy ground truth.

This is the "hardware" that the serving simulator runs on and that EcoPred
learns (the paper learns from measured GPU profiles; we derive the ground
truth from the same analytic quantities the dry-run's
``compiled.cost_analysis()`` reports — FLOPs and HBM bytes — plus the three
mechanisms of :mod:`repro.core.power`).

Latency model (serial composition, DESIGN.md §2):

    T(f) = (T_comp + (1-mu) * T_mem) * (f_max / f)  +  mu * T_mem * g(f)

* ``T_comp`` — GEMM/attention FLOPs at ``peak_flops * gemm_eff``, with the
  **MXU tile-quantization staircase**: the GEMM M-dim (batched tokens for
  prefill, batched requests for decode) is padded to a multiple of
  ``chip.mxu_tile`` before the FLOP count, which produces the paper's Fig. 6
  "staircase" discontinuities exactly (a 1-request overflow launches a whole
  new tile row).
* ``T_mem`` — weight + KV/SSM-state + activation HBM traffic at
  ``hbm_bw * mem_eff``; a fraction ``mu`` is truly DRAM-bound
  (frequency-independent above the memory knee, slowed by ``g(f) >= 1``
  below it), the rest rides the core clock (L2/NoC/issue).
* The TDP wall throttles the *effective* frequency before any of this
  (prefill at high f runs at the throttled clock, paper Fig. 5a).

The serial (non-overlapped) composition with the calibrated ``gemm_eff`` /
``mem_eff`` reproduces the paper's anchors: decode 1005->1410 MHz on A100
gives ITL x0.8 at energy x1.5; theta_prefill ~ 0.97, theta_decode ~ 0.62.

Everything here is a pure function of ``(ModelConfig, ChipSpec, phase
state, frequency)`` — no JAX, no device state — so the control plane can
query it thousands of times per simulated second.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import power as P
from repro_torch.core.power import ChipSpec

BF16 = 2  # bytes
F32 = 4


# ---------------------------------------------------------------------------
# Analytic per-iteration work accounting
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class IterWork:
    """FLOPs / bytes of one engine iteration (one forward of the batch)."""

    flops: float  # useful FLOPs (model-level, no padding)
    useful_flops: float  # == flops (kept for API compat)
    hbm_bytes: float  # weight + state + activation traffic
    gemm_m: int  # the GEMM M-dim (staircase-relevant)
    pad_flops: float = 0.0  # MXU tile-padding FLOPs (staircase waste)

    def __add__(self, o: "IterWork") -> "IterWork":
        return IterWork(
            self.flops + o.flops,
            self.useful_flops + o.useful_flops,
            self.hbm_bytes + o.hbm_bytes,
            max(self.gemm_m, o.gemm_m),
            self.pad_flops + o.pad_flops,
        )


def _pad_up(n: int, tile: int) -> int:
    return max(tile, ((n + tile - 1) // tile) * tile)


@lru_cache(maxsize=None)
def _body_params(cfg: ModelConfig) -> tuple:
    """(total_body, active_body, expert_params_per_layer*n_moe, n_moe_layers,
    attn_kv_bytes_per_token, mamba_state_bytes_per_req, non_moe_body)."""
    per_block_total = sum(cfg._layer_params(s)[0] for s in cfg.block_pattern)
    per_block_active = sum(cfg._layer_params(s)[1] for s in cfg.block_pattern)
    total = per_block_total * cfg.n_blocks
    active = per_block_active * cfg.n_blocks

    n_moe_layers = (
        sum(1 for s in cfg.block_pattern if s.ffn == "moe") * cfg.n_blocks
    )
    expert_params = (
        3 * cfg.d_model * cfg.moe.d_ff_expert if cfg.moe is not None else 0
    )
    # KV bytes appended per token (all attention layers, K+V); int8 cache
    # stores 1 B/elem plus per-(position, head) fp32 scales
    if cfg.kv_dtype == "int8":
        kv_bytes_tok = (
            2 * cfg.kv_dim + 2 * cfg.n_kv_heads * F32
        ) * cfg.n_attn_layers
    else:
        kv_bytes_tok = 2 * cfg.kv_dim * cfg.n_attn_layers * BF16
    # recurrent state bytes per request (SSM fp32 state + conv tail)
    state_bytes_req = 0
    if cfg.has_mamba:
        m = cfg.mamba
        n_mamba = (
            sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
            * cfg.n_blocks
        )
        ssm = m.n_heads(cfg.d_model) * m.head_dim * m.d_state * F32
        conv = (m.d_inner(cfg.d_model) + 2 * m.d_state) * (m.d_conv - 1) * BF16
        state_bytes_req = n_mamba * (ssm + conv)
    non_moe = total - n_moe_layers * (
        cfg.moe.num_experts * expert_params if cfg.moe else 0
    )
    return (total, active, expert_params, n_moe_layers, kv_bytes_tok,
            state_bytes_req, non_moe)


def _experts_touched(cfg: ModelConfig, n_tokens: int) -> float:
    """Expected number of distinct experts hit by ``n_tokens`` top-k draws.

    Coupon-collector expectation under uniform routing:
    E[touched] = E * (1 - (1 - k/E)^n). Decode batches typically touch all
    experts once n_req*k >> E; tiny batches touch ~n*k.
    """
    if cfg.moe is None:
        return 0.0
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    if n_tokens <= 0:
        return 0.0
    return E * (1.0 - (1.0 - k / E) ** n_tokens)


def prefill_work(
    cfg: ModelConfig,
    chip: ChipSpec,
    n_tok: int,
    avg_ctx: Optional[float] = None,
    tp: int = 1,
) -> IterWork:
    """Work of one prefill iteration over ``n_tok`` batched prompt tokens.

    ``avg_ctx`` is the mean prompt length in the batch (attention is
    quadratic in it); defaults to ``n_tok`` (single request).
    """
    if n_tok <= 0:
        return IterWork(0.0, 0.0, 0.0, 0)
    total, active, expert_p, n_moe, kv_b, st_b, non_moe = _body_params(cfg)
    avg_ctx = float(avg_ctx if avg_ctx is not None else n_tok)

    # GEMM flops: 2 * active params/token * tokens; M-dim tile padding is
    # tracked separately (it only costs time when compute-limited)
    m_pad = _pad_up(n_tok, chip.mxu_tile)
    gemm_useful = 2.0 * active * n_tok
    gemm_pad = 2.0 * active * (m_pad - n_tok)
    # attention: 4*Hq*Dh per (q,k) pair, causal avg ctx/2; windows clip it
    attn = 0.0
    for s in cfg.block_pattern:
        if s.mixer != "attn":
            continue
        span = avg_ctx / 2.0
        if s.window is not None:
            span = min(span, float(s.window))
        attn += 4.0 * cfg.q_dim * span * n_tok * cfg.n_blocks
    # mamba SSD: ~10 * d_inner * d_state flops/token/layer (intra+inter chunk)
    ssd = 0.0
    if cfg.has_mamba:
        m = cfg.mamba
        n_mamba = (
            sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
            * cfg.n_blocks
        )
        ssd = 10.0 * m.d_inner(cfg.d_model) * m.d_state * n_tok * n_mamba

    # bytes: weights (touched experts only) + activations + KV write
    touched = _experts_touched(cfg, n_tok)
    w_itemsize = 1.02 if cfg.weight_dtype == "int8" else BF16
    w_bytes = (non_moe + n_moe * touched * expert_p) * w_itemsize
    act_bytes = 12.0 * cfg.d_model * n_tok * BF16  # residual stream traffic
    kv_write = kv_b * n_tok + (st_b * (n_tok / max(avg_ctx, 1.0)))
    flops = (gemm_useful + attn + ssd) / tp
    return IterWork(
        flops=flops,
        useful_flops=flops,
        hbm_bytes=(w_bytes + act_bytes + kv_write) / tp,
        gemm_m=n_tok,
        pad_flops=gemm_pad / tp,
    )


def prefill_chunk_work(
    cfg: ModelConfig,
    chip: ChipSpec,
    n_new: int,
    n_ctx: int = 0,
    n_reqs: int = 1,
    tp: int = 1,
) -> IterWork:
    """Work of one *partial* prefill iteration (chunked prefill).

    ``n_new`` new prompt tokens are computed this iteration against
    ``n_ctx`` prior context tokens total across the batch — radix-cache
    hits plus earlier chunks of the same prompts.  Differences from a
    whole-prompt iteration of the same size:

    * attention spans the prior context too: each new token attends to its
      request's full resident prefix (quadratic term split across chunks);
    * the prior context's KV is **read** from HBM (the chunk's attention
      streams it), while only the new tokens' KV is written;
    * weights stream once per chunk, so splitting a prompt into k chunks
      pays the weight traffic k times — the classic chunked-prefill
      overhead that the cost model must price for EcoFreq to pick honest
      clocks.

    With ``n_ctx == 0`` and ``n_reqs == 1`` this reduces exactly to
    :func:`prefill_work` (modulo the identical stream terms).
    """
    if n_new <= 0:
        return IterWork(0.0, 0.0, 0.0, 0)
    total, active, expert_p, n_moe, kv_b, st_b, non_moe = _body_params(cfg)
    n_reqs = max(1, n_reqs)
    ctx_per_req = n_ctx / n_reqs
    new_per_req = n_new / n_reqs

    m_pad = _pad_up(n_new, chip.mxu_tile)
    gemm_useful = 2.0 * active * n_new
    gemm_pad = 2.0 * active * (m_pad - n_new)
    # attention: each new token attends to (prior ctx + causal half of its
    # own chunk); sliding windows clip the span exactly as in prefill_work
    attn = 0.0
    for s in cfg.block_pattern:
        if s.mixer != "attn":
            continue
        span = ctx_per_req + new_per_req / 2.0
        if s.window is not None:
            span = min(span, float(s.window))
        attn += 4.0 * cfg.q_dim * span * n_new * cfg.n_blocks
    ssd = 0.0
    if cfg.has_mamba:
        m = cfg.mamba
        n_mamba = (
            sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
            * cfg.n_blocks
        )
        ssd = 10.0 * m.d_inner(cfg.d_model) * m.d_state * n_new * n_mamba

    touched = _experts_touched(cfg, n_new)
    w_itemsize = 1.02 if cfg.weight_dtype == "int8" else BF16
    w_bytes = (non_moe + n_moe * touched * expert_p) * w_itemsize
    act_bytes = 12.0 * cfg.d_model * n_new * BF16
    kv_write = kv_b * n_new
    kv_read = kv_b * n_ctx  # resident prefix streamed by the chunk's attn
    st_rw = 2 * st_b * n_reqs  # recurrent state resumes per chunk
    flops = (gemm_useful + attn + ssd) / tp
    return IterWork(
        flops=flops,
        useful_flops=flops,
        hbm_bytes=(w_bytes + act_bytes + kv_write + kv_read + st_rw) / tp,
        gemm_m=n_new,
        pad_flops=gemm_pad / tp,
    )


def verify_work(
    cfg: ModelConfig,
    chip: ChipSpec,
    n_req: int,
    n_kv: int,
    k: int,
    tp: int = 1,
) -> IterWork:
    """Work of one speculative *verify* iteration: ``n_req`` running
    requests each forward ``k + 1`` query rows (the pending token plus
    ``k`` draft proposals) against ``n_kv`` resident KV tokens.

    What changes vs :func:`decode_work` — and why the energy sweet spot
    moves — is the asymmetry between compute and memory:

    * the **byte** streams barely grow: weights and the resident KV are
      read once and shared by all ``k+1`` rows (only the k extra KV
      writes and activations add).  That amortization is the whole
      point of speculative decoding;
    * the **FLOPs** multiply by ``k+1`` — but the *incremental* rows'
      GEMM and attention MACs ride the very streams they share, so
      like MXU tile padding they only cost wall time to the extent the
      iteration is compute-limited.  They are accounted in
      ``pad_flops`` (the ``kappa``-hidden term of :func:`iter_cost`):
      free while memory-bound, priced as the batch drives the GEMM
      compute-bound — which is exactly when speculation stops paying;
    * the GEMM M-dim staircases on ``n_req * (k+1)``, shifting the
      Fig. 6 cliffs left in ``n_req``.

    With ``k == 0`` this reduces to :func:`decode_work` modulo the
    single-token KV write the legacy decode model omits.
    """
    if n_req <= 0:
        return IterWork(0.0, 0.0, 0.0, 0)
    total, active, expert_p, n_moe, kv_b, st_b, non_moe = _body_params(cfg)
    rows = n_req * (k + 1)

    m_pad = _pad_up(rows, chip.mxu_tile)
    gemm_base = 2.0 * active * n_req  # the non-speculative row per req
    gemm_spec = 2.0 * active * n_req * k  # extra rows: stream-hidden
    gemm_pad = 2.0 * active * (m_pad - rows)
    attn_base = attn_spec = 0.0
    if cfg.has_attention:
        attn_base = 4.0 * cfg.q_dim * cfg.n_attn_layers * n_kv
        # k extra context reads + the causal triangle over the freshly
        # written speculation window — all riding the single KV stream
        attn_spec = 4.0 * cfg.q_dim * cfg.n_attn_layers * (
            k * n_kv + n_req * (k + 1) * k / 2.0
        )
    ssd = 0.0
    if cfg.has_mamba:
        m = cfg.mamba
        n_mamba = (
            sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
            * cfg.n_blocks
        )
        ssd = 6.0 * m.d_inner(cfg.d_model) * m.d_state * rows * n_mamba

    touched = _experts_touched(cfg, rows)
    w_itemsize = 1.02 if cfg.weight_dtype == "int8" else BF16
    w_bytes = (non_moe + n_moe * touched * expert_p) * w_itemsize
    kv_read = kv_b * n_kv  # streamed ONCE, shared by all k+1 rows
    kv_write = kv_b * rows
    st_rw = 2 * st_b * n_req
    act_bytes = 12.0 * cfg.d_model * rows * BF16
    flops = (gemm_base + attn_base + ssd) / tp
    return IterWork(
        flops=flops,
        useful_flops=flops,
        hbm_bytes=(w_bytes + kv_read + kv_write + st_rw + act_bytes) / tp,
        gemm_m=rows,
        pad_flops=(gemm_spec + attn_spec + gemm_pad) / tp,
    )


def draft_work(
    cfg: ModelConfig,
    chip: ChipSpec,
    n_req: int,
    n_kv: int,
    frac: float,
    tp: int = 1,
) -> IterWork:
    """Work of one *draft-model* decode step for ``n_req`` requests.

    The draft model is priced as a ``frac``-scaled shadow of the target:
    its weight stream, GEMM FLOPs and (proportionally smaller) KV read
    all shrink by ``frac`` — the standard small-draft regime (a ~10%
    drafter).  The M-dim staircase is computed on the *scaled* pad
    FLOPs so tiny drafters do not inherit the target's tile waste.
    """
    w = decode_work(cfg, chip, n_req, n_kv, tp)
    return IterWork(
        flops=w.flops * frac,
        useful_flops=w.useful_flops * frac,
        hbm_bytes=w.hbm_bytes * frac,
        gemm_m=w.gemm_m,
        pad_flops=w.pad_flops * frac,
    )


def decode_work(
    cfg: ModelConfig,
    chip: ChipSpec,
    n_req: int,
    n_kv: int,
    tp: int = 1,
) -> IterWork:
    """Work of one decode iteration: ``n_req`` running requests, ``n_kv``
    total tokens resident in KV cache across them."""
    if n_req <= 0:
        return IterWork(0.0, 0.0, 0.0, 0)
    total, active, expert_p, n_moe, kv_b, st_b, non_moe = _body_params(cfg)

    m_pad = _pad_up(n_req, chip.mxu_tile)
    gemm_useful = 2.0 * active * n_req
    gemm_pad = 2.0 * active * (m_pad - n_req)
    # attention reads every cached token once per decode step.
    # ``n_kv`` follows the paper's definition: token positions resident in
    # the cache summed over requests (each position stores K/V per layer),
    # so both flops and bytes multiply by the attention layer count.
    attn = 0.0
    if cfg.has_attention:
        attn = 4.0 * cfg.q_dim * n_kv * cfg.n_attn_layers
    ssd = 0.0
    if cfg.has_mamba:
        m = cfg.mamba
        n_mamba = (
            sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
            * cfg.n_blocks
        )
        # state update + output read: ~6 * d_inner * d_state per req/layer
        ssd = 6.0 * m.d_inner(cfg.d_model) * m.d_state * n_req * n_mamba

    touched = _experts_touched(cfg, n_req)
    w_itemsize = 1.02 if cfg.weight_dtype == "int8" else BF16
    w_bytes = (non_moe + n_moe * touched * expert_p) * w_itemsize
    kv_read = kv_b * n_kv  # dtype-aware (see _body_params)
    st_rw = 2 * st_b * n_req  # read + write recurrent state
    act_bytes = 12.0 * cfg.d_model * n_req * BF16
    flops = (gemm_useful + attn + ssd) / tp
    return IterWork(
        flops=flops,
        useful_flops=flops,
        hbm_bytes=(w_bytes + kv_read + st_rw + act_bytes) / tp,
        gemm_m=n_req,
        pad_flops=gemm_pad / tp,
    )


# ---------------------------------------------------------------------------
# Latency / power / energy at an operating point
# ---------------------------------------------------------------------------


class IterCost(NamedTuple):
    """Immutable per-iteration price (NamedTuple rather than a frozen
    dataclass: the tuple constructor is ~2x cheaper, and this is built
    once per priced iteration on the event-loop hot path)."""

    time_s: float
    power_w: float
    energy_j: float
    f_effective: float  # post-TDP-throttle clock
    theta: float  # f-scalable time share (drives power utilization)


@dataclass(frozen=True, slots=True)
class IterCostBatch:
    """Struct-of-arrays twin of :class:`IterCost`.

    Produced by the ``HardwareModel.*_iter_batch`` pricers: element ``i``
    of every field is bit-identical to the corresponding scalar
    ``*_iter`` call on the ``i``-th state tuple.  ``row(i)`` materializes
    that scalar view when a caller needs a plain :class:`IterCost`.
    """

    time_s: np.ndarray
    power_w: np.ndarray
    energy_j: np.ndarray
    f_effective: np.ndarray
    theta: np.ndarray

    def __len__(self) -> int:
        return len(self.time_s)

    def row(self, i: int) -> IterCost:
        return IterCost(
            float(self.time_s[i]),
            float(self.power_w[i]),
            float(self.energy_j[i]),
            float(self.f_effective[i]),
            float(self.theta[i]),
        )


def _raw_times(chip: ChipSpec, work: IterWork) -> tuple:
    t_comp = work.flops / (chip.peak_flops * chip.gemm_eff)
    t_mem = work.hbm_bytes / (chip.hbm_bw * chip.mem_eff)
    return t_comp, t_mem


def iter_cost(chip: ChipSpec, work: IterWork, f: float) -> IterCost:
    """Latency + power + energy of one iteration at frequency ``f`` (MHz).

    MXU tile-padding FLOPs only cost wall time to the extent the GEMM is
    compute-limited: when memory-bound, under-filled tiles hide behind the
    weight/KV streams. The hiding factor ``kappa = min(1, t_comp/t_mem)``
    makes the staircase strong near full tiles at large batch (paper
    Fig. 6) while keeping small-batch decode memory-bound with weak
    frequency sensitivity (paper Fig. 4).
    """
    t_comp, t_mem = _raw_times(chip, work)
    if t_comp + t_mem <= 0.0:
        return IterCost(0.0, chip.p_idle, 0.0, f, 0.0)
    kappa = min(1.0, t_comp / max(t_mem, 1e-12))
    t_pad = kappa * work.pad_flops / (chip.peak_flops * chip.gemm_eff)
    mu = chip.mu_dram
    t_scal = t_comp + t_pad + (1.0 - mu) * t_mem  # core-clock-coupled
    t_dram = mu * t_mem  # DRAM-bound
    theta = t_scal / (t_scal + t_dram)
    util = P.power_util(chip, theta)
    f_eff = P.throttled_frequency(chip, f, util)
    time_s = t_scal * (chip.f_max / f_eff) + t_dram * P.mem_slowdown(
        chip, f_eff
    )
    p = P.power(chip, f_eff, util)
    return IterCost(time_s, p, p * time_s, f_eff, theta)


def iter_time(chip: ChipSpec, work: IterWork, f: float) -> float:
    return iter_cost(chip, work, f).time_s


# ---------------------------------------------------------------------------
# Precomputed pricing table: fast scalar paths + array-native batch twins
# ---------------------------------------------------------------------------


def _specialize_decode_cost(tab):
    """Build the per-table decode pricer with every constant bound as a
    closure variable and the model-structure branches resolved at build
    time — the event loop prices one decode iteration per event through
    this, so per-call attribute traffic and dead bytecode matter.

    The generated float sequence is exactly
    ``tab.cost(*tab.decode_terms(...), f)`` up to two provably
    bit-neutral rewrites:

    * structurally-zero work terms are dropped (``x + 0.0 == x`` for
      the non-negative operands here — no ``-0.0`` can appear);
    * ``/ tp`` is dropped when ``tp == 1`` (IEEE division by one is
      exact).

    ``tests/test_hwmodel_batch.py`` sweeps every generated variant
    (attention/Mamba/MoE/hybrid x tp) against the composed path to the
    bit."""
    (tile, two_active, a4q, n_attn_layers, has_attention, s6,
     n_mamba, has_mamba, is_moe, w_bytes0, tp, kv_b, st2, a12d,
     comp_den, mem_den, p_idle, omm, mu, u_k0, u_k1, f_max, xk_v,
     volt_slope, d_xkv, dp, v1sq, tdp, f_min, xk_m, gamma) = tab._dc
    div_tp = "" if tp == 1 else " / tp"
    flops_terms = ["two_active * n_req"]
    if has_attention:
        flops_terms.append("a4q * n_kv * n_attn_layers")
    if has_mamba:
        flops_terms.append("s6 * n_req * n_mamba")
    hbm_terms = ["w_bytes_moe(n_req)" if is_moe else "w_bytes0"]
    if kv_b != 0.0:
        hbm_terms.append("kv_b * n_kv")
    if st2 != 0.0:
        hbm_terms.append("st2 * n_req")
    hbm_terms.append("a12d * n_req * bf16")
    src = f"""
def _make(tile, two_active, a4q, n_attn_layers, s6, n_mamba, w_bytes0,
          w_bytes_moe, tp, kv_b, st2, a12d, bf16, comp_den, mem_den,
          p_idle, omm, mu, u_k0, u_k1, f_max, xk_v, volt_slope, d_xkv,
          dp, v1sq, tdp, f_min, xk_m, gamma, power):
  def decode_cost(n_req, n_kv, f):
    m_pad = max(tile, ((n_req + tile - 1) // tile) * tile)
    gemm_pad = two_active * (m_pad - n_req)
    flops = ({" + ".join(flops_terms)}){div_tp}
    hbm = ({" + ".join(hbm_terms)}){div_tp}
    t_comp = flops / comp_den
    t_mem = hbm / mem_den
    if t_comp + t_mem <= 0.0:
        return (0.0, p_idle, 0.0, f, 0.0)
    kappa = min(1.0, t_comp / max(t_mem, 1e-12))
    t_pad = kappa * (gemm_pad{div_tp}) / comp_den
    t_scal = t_comp + t_pad + omm * t_mem
    t_dram = mu * t_mem
    theta = t_scal / (t_scal + t_dram)
    util = min(1.0, max(0.05, u_k0 + u_k1 * theta))
    x = f / f_max
    if x <= xk_v:
        v = 1.0
    else:
        v = 1.0 + volt_slope * (x - xk_v) / d_xkv
    p = p_idle + dp * util * x * (v * v) / v1sq
    if p > tdp:
        lo, hi = f_min, f
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if power(mid, util) <= tdp:
                lo = mid
            else:
                hi = mid
        f = lo
        p = power(f, util)
    x = f / f_max
    g = 1.0 if x >= xk_m else (xk_m / x) ** gamma
    time_s = t_scal * (f_max / f) + t_dram * g
    return (time_s, p, p * time_s, f, theta)
  return decode_cost
"""
    ns = {}
    exec(src, ns)  # noqa: S102 — generated from the literals above
    return ns["_make"](
        tile, two_active, a4q, n_attn_layers, s6, n_mamba, w_bytes0,
        tab._w_bytes, tp, kv_b, st2, a12d, BF16, comp_den, mem_den,
        p_idle, omm, mu, u_k0, u_k1, f_max, xk_v, volt_slope, d_xkv,
        dp, v1sq, tdp, f_min, xk_m, gamma, tab._power,
    )


class _PricingTable:
    """Constant folding of ``(cfg, chip, tp)`` for the iteration pricers.

    The ``HardwareModel.*_iter`` scalar methods and their array-native
    ``*_iter_batch`` twins both evaluate *exactly* the reference
    expressions of the ``*_work`` functions and :func:`iter_cost`, with
    products pre-reduced only along their leftmost (left-associative)
    prefix — IEEE-exact, so every result is bit-identical to the
    reference functions, which remain the documented ground truth.

    The two transcendentals (the MoE coupon-collector ``**`` and the
    below-knee ``(xk/x)**gamma`` memory slowdown) go through Python's
    ``float.__pow__`` in the batch path too: NumPy's SIMD ``np.power``
    does not round identically to libm on this platform, and the energy
    pins are gated to the ulp.
    """

    __slots__ = (
        "tp", "tile", "two_active", "a4q", "a4qn", "n_blocks",
        "n_attn_layers", "has_attention", "attn_windows",
        "has_mamba", "n_mamba", "s6", "s10",
        "is_moe", "E", "moe_base", "expert_p", "n_moe", "non_moe",
        "w_itemsize", "w_bytes0", "kv_b", "st_b", "st2", "a12d",
        "comp_den", "mem_den", "mu", "omm", "u_k0", "u_k1",
        "f_max", "f_min", "tdp", "p_idle", "dp",
        "xk_v", "volt_slope", "d_xkv", "v1sq", "xk_m", "gamma",
        "_dc", "_dc_fn",
    )

    def __init__(self, cfg: ModelConfig, chip: ChipSpec, tp: int):
        total, active, expert_p, n_moe, kv_b, st_b, non_moe = \
            _body_params(cfg)
        self.tp = tp
        self.tile = chip.mxu_tile
        self.two_active = 2.0 * active
        self.a4q = 4.0 * cfg.q_dim
        self.a4qn = 4.0 * cfg.q_dim * cfg.n_attn_layers
        self.n_blocks = cfg.n_blocks
        self.n_attn_layers = cfg.n_attn_layers
        self.has_attention = cfg.has_attention
        self.attn_windows = tuple(
            s.window for s in cfg.block_pattern if s.mixer == "attn"
        )
        self.has_mamba = cfg.has_mamba
        if cfg.has_mamba:
            m = cfg.mamba
            self.n_mamba = (
                sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
                * cfg.n_blocks
            )
            self.s6 = 6.0 * m.d_inner(cfg.d_model) * m.d_state
            self.s10 = 10.0 * m.d_inner(cfg.d_model) * m.d_state
        else:
            self.n_mamba = 0
            self.s6 = self.s10 = 0.0
        self.is_moe = cfg.moe is not None
        if self.is_moe:
            self.E = cfg.moe.num_experts
            self.moe_base = 1.0 - cfg.moe.top_k / cfg.moe.num_experts
        else:
            self.E = 0
            self.moe_base = 0.0
        self.expert_p = expert_p
        self.n_moe = n_moe
        self.non_moe = non_moe
        self.w_itemsize = 1.02 if cfg.weight_dtype == "int8" else BF16
        self.w_bytes0 = (non_moe + n_moe * 0.0 * expert_p) * self.w_itemsize
        self.kv_b = kv_b
        self.st_b = st_b
        self.st2 = 2 * st_b
        self.a12d = 12.0 * cfg.d_model
        self.comp_den = chip.peak_flops * chip.gemm_eff
        self.mem_den = chip.hbm_bw * chip.mem_eff
        self.mu = chip.mu_dram
        self.omm = 1.0 - chip.mu_dram
        self.u_k0 = chip.u_k0
        self.u_k1 = chip.u_k1
        self.f_max = chip.f_max
        self.f_min = chip.f_min
        self.tdp = chip.tdp
        self.p_idle = chip.p_idle
        self.dp = chip.p_elec_max - chip.p_idle
        self.xk_v = chip.x_volt_knee
        self.volt_slope = chip.volt_slope
        self.d_xkv = 1.0 - chip.x_volt_knee
        v1 = P.voltage(chip, chip.f_max)
        self.v1sq = v1 * v1
        self.xk_m = chip.x_mem_knee
        self.gamma = chip.mem_knee_gamma
        # decode_cost fast-path constants: one tuple unpack replaces ~30
        # per-call attribute loads (the same float objects — bit-neutral)
        self._dc = (
            self.tile, self.two_active, self.a4q, self.n_attn_layers,
            self.has_attention, self.s6, self.n_mamba, self.has_mamba,
            self.is_moe, self.w_bytes0, self.tp, self.kv_b, self.st2,
            self.a12d, self.comp_den, self.mem_den, self.p_idle,
            self.omm, self.mu, self.u_k0, self.u_k1, self.f_max,
            self.xk_v, self.volt_slope, self.d_xkv, self.dp, self.v1sq,
            self.tdp, self.f_min, self.xk_m, self.gamma,
        )
        self._dc_fn = _specialize_decode_cost(self)

    # -- scalar fast path ---------------------------------------------------

    def _touched(self, n: int) -> float:
        if not self.is_moe or n <= 0:
            return 0.0
        return self.E * (1.0 - self.moe_base ** n)

    def _w_bytes(self, n: int) -> float:
        if not self.is_moe:
            return self.w_bytes0
        touched = self._touched(n)
        return (self.non_moe + self.n_moe * touched * self.expert_p) \
            * self.w_itemsize

    def _power(self, f: float, util: float) -> float:
        x = f / self.f_max
        if x <= self.xk_v:
            v = 1.0
        else:
            v = 1.0 + self.volt_slope * (x - self.xk_v) / self.d_xkv
        return self.p_idle + self.dp * util * x * (v * v) / self.v1sq

    def cost(self, flops, hbm, pad, f):
        """(time_s, power_w, energy_j, f_eff, theta) pre-``tp`` scaling —
        bit-identical to :func:`iter_cost` on the same work terms."""
        t_comp = flops / self.comp_den
        t_mem = hbm / self.mem_den
        if t_comp + t_mem <= 0.0:
            return (0.0, self.p_idle, 0.0, f, 0.0)
        kappa = min(1.0, t_comp / max(t_mem, 1e-12))
        t_pad = kappa * pad / self.comp_den
        t_scal = t_comp + t_pad + self.omm * t_mem
        t_dram = self.mu * t_mem
        theta = t_scal / (t_scal + t_dram)
        util = min(1.0, max(0.05, self.u_k0 + self.u_k1 * theta))
        p = self._power(f, util)
        if p <= self.tdp:
            f_eff = f
        else:
            lo, hi = self.f_min, f
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if self._power(mid, util) <= self.tdp:
                    lo = mid
                else:
                    hi = mid
            f_eff = lo
            p = self._power(f_eff, util)
        x = f_eff / self.f_max
        g = 1.0 if x >= self.xk_m else (self.xk_m / x) ** self.gamma
        time_s = t_scal * (self.f_max / f_eff) + t_dram * g
        return (time_s, p, p * time_s, f_eff, theta)

    def decode_cost(self, n_req, n_kv, f):
        """terms + cost fused into one flat body — the SimBackend hot
        path prices a decode iteration here with no intermediate
        calls.  The implementation lives in the per-table closure
        ``_dc_fn`` (constants bound at table build); it evaluates
        operation-for-operation the same float sequence as
        ``cost(*decode_terms(...), f)``, so the result is bit-exact
        with the composed path (pinned by tests/test_hwmodel_batch.py
        and the golden energy pins)."""
        return self._dc_fn(n_req, n_kv, f)

    def decode_terms(self, n_req, n_kv):
        m_pad = _pad_up(n_req, self.tile)
        gemm_useful = self.two_active * n_req
        gemm_pad = self.two_active * (m_pad - n_req)
        attn = (self.a4q * n_kv * self.n_attn_layers
                if self.has_attention else 0.0)
        ssd = self.s6 * n_req * self.n_mamba if self.has_mamba else 0.0
        hbm = (self._w_bytes(n_req) + self.kv_b * n_kv + self.st2 * n_req
               + self.a12d * n_req * BF16) / self.tp
        return (gemm_useful + attn + ssd) / self.tp, hbm, gemm_pad / self.tp

    def verify_terms(self, n_req, n_kv, k):
        rows = n_req * (k + 1)
        m_pad = _pad_up(rows, self.tile)
        gemm_base = self.two_active * n_req
        gemm_spec = self.two_active * n_req * k
        gemm_pad = self.two_active * (m_pad - rows)
        attn_base = attn_spec = 0.0
        if self.has_attention:
            attn_base = self.a4qn * n_kv
            attn_spec = self.a4qn * (k * n_kv + n_req * (k + 1) * k / 2.0)
        ssd = self.s6 * rows * self.n_mamba if self.has_mamba else 0.0
        hbm = (self._w_bytes(rows) + self.kv_b * n_kv + self.kv_b * rows
               + self.st2 * n_req + self.a12d * rows * BF16) / self.tp
        return (
            (gemm_base + attn_base + ssd) / self.tp,
            hbm,
            (gemm_spec + attn_spec + gemm_pad) / self.tp,
        )

    def prefill_terms(self, n_tok, avg_ctx):
        # ``avg_ctx`` is already a float (caller applied the None default)
        m_pad = _pad_up(n_tok, self.tile)
        gemm_useful = self.two_active * n_tok
        gemm_pad = self.two_active * (m_pad - n_tok)
        attn = 0.0
        for w in self.attn_windows:
            span = avg_ctx / 2.0
            if w is not None:
                span = min(span, float(w))
            attn += self.a4q * span * n_tok * self.n_blocks
        ssd = self.s10 * n_tok * self.n_mamba if self.has_mamba else 0.0
        kv_write = self.kv_b * n_tok + (
            self.st_b * (n_tok / max(avg_ctx, 1.0))
        )
        hbm = (self._w_bytes(n_tok) + self.a12d * n_tok * BF16
               + kv_write) / self.tp
        return (gemm_useful + attn + ssd) / self.tp, hbm, gemm_pad / self.tp

    def chunk_terms(self, n_new, n_ctx, n_reqs):
        n_reqs = max(1, n_reqs)
        ctx_per_req = n_ctx / n_reqs
        new_per_req = n_new / n_reqs
        m_pad = _pad_up(n_new, self.tile)
        gemm_useful = self.two_active * n_new
        gemm_pad = self.two_active * (m_pad - n_new)
        attn = 0.0
        for w in self.attn_windows:
            span = ctx_per_req + new_per_req / 2.0
            if w is not None:
                span = min(span, float(w))
            attn += self.a4q * span * n_new * self.n_blocks
        ssd = self.s10 * n_new * self.n_mamba if self.has_mamba else 0.0
        hbm = (self._w_bytes(n_new) + self.a12d * n_new * BF16
               + self.kv_b * n_new + self.kv_b * n_ctx
               + self.st2 * n_reqs) / self.tp
        return (gemm_useful + attn + ssd) / self.tp, hbm, gemm_pad / self.tp

    def hybrid_terms(self, n_req, n_kv, n_new, n_ctx, n_pre_reqs):
        if n_req > 0:
            fd, hd, pd = self.decode_terms(n_req, n_kv)
        else:
            fd = hd = pd = 0.0
        if n_new > 0:
            fp, hp, pp = self.chunk_terms(n_new, n_ctx, n_pre_reqs)
        else:
            fp = hp = pp = 0.0
        flops, hbm, pad = fd + fp, hd + hp, pd + pp
        if n_req > 0 and n_new > 0:
            touched = self._touched(min(n_req, n_new))
            dup = (self.non_moe + self.n_moe * touched * self.expert_p) \
                * self.w_itemsize / self.tp
            hbm = max(hbm - dup, 0.0)
        return flops, hbm, pad

    # -- array-native batch twins -------------------------------------------

    def _touched_arr(self, n: np.ndarray) -> np.ndarray:
        out = np.zeros(n.shape)
        if not self.is_moe:
            return out
        base, E = self.moe_base, self.E
        nz = np.nonzero(n > 0)[0]
        if len(nz):
            # Python pow per element: np.power rounds differently here
            out[nz] = [E * (1.0 - base ** ni) for ni in n[nz].tolist()]
        return out

    def _w_bytes_arr(self, n: np.ndarray):
        if not self.is_moe:
            return self.w_bytes0
        touched = self._touched_arr(n)
        return (self.non_moe + self.n_moe * touched * self.expert_p) \
            * self.w_itemsize

    def _power_arr(self, f: np.ndarray, util: np.ndarray) -> np.ndarray:
        x = f / self.f_max
        v = np.where(
            x <= self.xk_v,
            1.0,
            1.0 + self.volt_slope * (x - self.xk_v) / self.d_xkv,
        )
        return self.p_idle + self.dp * util * x * (v * v) / self.v1sq

    def cost_arr(self, flops, hbm, pad, f):
        """Vectorized twin of :meth:`cost` (pre-``tp``-scaling arrays).

        Zero-work lanes (work terms forced to 0.0 by the ``*_terms_arr``
        producers, mirroring the scalar early returns) reproduce the
        scalar zero branch ``(0, p_idle, 0, f, 0)`` exactly.
        """
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            t_comp = flops / self.comp_den
            t_mem = hbm / self.mem_den
            z = (t_comp + t_mem) <= 0.0
            kappa = np.minimum(1.0, t_comp / np.maximum(t_mem, 1e-12))
            t_pad = kappa * pad / self.comp_den
            t_scal = t_comp + t_pad + self.omm * t_mem
            t_dram = self.mu * t_mem
            denom = t_scal + t_dram
            theta = np.where(
                z, 0.0, t_scal / np.where(denom > 0.0, denom, 1.0)
            )
            util = np.minimum(
                1.0, np.maximum(0.05, self.u_k0 + self.u_k1 * theta)
            )
            p = self._power_arr(f, util)
            f_eff = np.array(f, dtype=np.float64)  # writable copy
            need = (p > self.tdp) & ~z
            if need.any():
                u_n = util[need]
                lo = np.full(u_n.shape, self.f_min)
                hi = np.array(f[need], dtype=np.float64)
                for _ in range(40):
                    mid = 0.5 * (lo + hi)
                    ok = self._power_arr(mid, u_n) <= self.tdp
                    lo = np.where(ok, mid, lo)
                    hi = np.where(ok, hi, mid)
                f_eff[need] = lo
                p[need] = self._power_arr(lo, u_n)
            x = f_eff / self.f_max
            g = np.ones_like(x)
            below = np.nonzero((x < self.xk_m) & ~z)[0]
            if len(below):
                xk, gm = self.xk_m, self.gamma
                g[below] = [
                    (xk / xi) ** gm for xi in x[below].tolist()
                ]
            time_s = t_scal * (self.f_max / f_eff) + t_dram * g
            energy = p * time_s
        time_s = np.where(z, 0.0, time_s)
        p = np.where(z, self.p_idle, p)
        energy = np.where(z, 0.0, energy)
        return time_s, p, energy, f_eff, theta

    @staticmethod
    def _zero_lanes(zero, flops, hbm, pad):
        if zero.any():
            flops = np.where(zero, 0.0, flops)
            hbm = np.where(zero, 0.0, hbm)
            pad = np.where(zero, 0.0, pad)
        return flops, hbm, pad

    def decode_terms_arr(self, n_req, n_kv):
        tile = self.tile
        m_pad = np.maximum(tile, ((n_req + tile - 1) // tile) * tile)
        gemm_useful = self.two_active * n_req
        gemm_pad = self.two_active * (m_pad - n_req)
        attn = (self.a4q * n_kv * self.n_attn_layers
                if self.has_attention else 0.0)
        ssd = self.s6 * n_req * self.n_mamba if self.has_mamba else 0.0
        hbm = (self._w_bytes_arr(n_req) + self.kv_b * n_kv
               + self.st2 * n_req + self.a12d * n_req * BF16) / self.tp
        return self._zero_lanes(
            n_req <= 0,
            (gemm_useful + attn + ssd) / self.tp, hbm, gemm_pad / self.tp,
        )

    def verify_terms_arr(self, n_req, n_kv, k):
        rows = n_req * (k + 1)
        tile = self.tile
        m_pad = np.maximum(tile, ((rows + tile - 1) // tile) * tile)
        gemm_base = self.two_active * n_req
        gemm_spec = self.two_active * n_req * k
        gemm_pad = self.two_active * (m_pad - rows)
        attn_base = attn_spec = 0.0
        if self.has_attention:
            attn_base = self.a4qn * n_kv
            attn_spec = self.a4qn * (k * n_kv + n_req * (k + 1) * k / 2.0)
        ssd = self.s6 * rows * self.n_mamba if self.has_mamba else 0.0
        hbm = (self._w_bytes_arr(rows) + self.kv_b * n_kv
               + self.kv_b * rows + self.st2 * n_req
               + self.a12d * rows * BF16) / self.tp
        return self._zero_lanes(
            n_req <= 0,
            (gemm_base + attn_base + ssd) / self.tp,
            hbm,
            (gemm_spec + attn_spec + gemm_pad) / self.tp,
        )

    def prefill_terms_arr(self, n_tok, avg_ctx):
        tile = self.tile
        m_pad = np.maximum(tile, ((n_tok + tile - 1) // tile) * tile)
        gemm_useful = self.two_active * n_tok
        gemm_pad = self.two_active * (m_pad - n_tok)
        attn = 0.0
        for w in self.attn_windows:
            span = avg_ctx / 2.0
            if w is not None:
                span = np.minimum(span, float(w))
            attn = attn + self.a4q * span * n_tok * self.n_blocks
        ssd = self.s10 * n_tok * self.n_mamba if self.has_mamba else 0.0
        kv_write = self.kv_b * n_tok + (
            self.st_b * (n_tok / np.maximum(avg_ctx, 1.0))
        )
        hbm = (self._w_bytes_arr(n_tok) + self.a12d * n_tok * BF16
               + kv_write) / self.tp
        return self._zero_lanes(
            n_tok <= 0,
            (gemm_useful + attn + ssd) / self.tp, hbm, gemm_pad / self.tp,
        )

    def chunk_terms_arr(self, n_new, n_ctx, n_reqs):
        n_reqs = np.maximum(1, n_reqs)
        ctx_per_req = n_ctx / n_reqs
        new_per_req = n_new / n_reqs
        tile = self.tile
        m_pad = np.maximum(tile, ((n_new + tile - 1) // tile) * tile)
        gemm_useful = self.two_active * n_new
        gemm_pad = self.two_active * (m_pad - n_new)
        attn = 0.0
        for w in self.attn_windows:
            span = ctx_per_req + new_per_req / 2.0
            if w is not None:
                span = np.minimum(span, float(w))
            attn = attn + self.a4q * span * n_new * self.n_blocks
        ssd = self.s10 * n_new * self.n_mamba if self.has_mamba else 0.0
        hbm = (self._w_bytes_arr(n_new) + self.a12d * n_new * BF16
               + self.kv_b * n_new + self.kv_b * n_ctx
               + self.st2 * n_reqs) / self.tp
        return self._zero_lanes(
            n_new <= 0,
            (gemm_useful + attn + ssd) / self.tp, hbm, gemm_pad / self.tp,
        )

    def hybrid_terms_arr(self, n_req, n_kv, n_new, n_ctx, n_pre_reqs):
        fd, hd, pd = self.decode_terms_arr(n_req, n_kv)
        fp, hp, pp = self.chunk_terms_arr(n_new, n_ctx, n_pre_reqs)
        flops, hbm, pad = fd + fp, hd + hp, pd + pp
        both = (n_req > 0) & (n_new > 0)
        if both.any():
            touched = self._touched_arr(np.minimum(n_req, n_new))
            dup = (self.non_moe + self.n_moe * touched * self.expert_p) \
                * self.w_itemsize / self.tp
            hbm = np.where(both, np.maximum(hbm - dup, 0.0), hbm)
        return flops, hbm, pad


@lru_cache(maxsize=None)
def _pricing_table(cfg: ModelConfig, chip: ChipSpec, tp: int) -> _PricingTable:
    return _PricingTable(cfg, chip, tp)


def _batch_args(table: _PricingTable, *specs):
    """Coerce/broadcast batch-pricer inputs to flat same-length arrays.

    Each spec is ``(value, dtype)``; a ``None`` value (the frequency
    argument) takes the chip's ``f_max`` default, matching the scalar
    pricers."""
    arrs = []
    for val, dt in specs:
        if val is None:
            val = table.f_max
        arrs.append(np.asarray(val, dtype=dt))
    return [a.ravel() for a in np.broadcast_arrays(*arrs)]


# ---------------------------------------------------------------------------
# Instance-level hardware model (what SimEngine + profiling query)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareModel:
    """Latency/energy oracle for one serving instance of ``cfg`` on ``chip``.

    ``tp`` is the tensor-parallel degree of the instance (per-chip work and
    weight bytes divide by it; energy multiplies back by ``tp`` chips).
    """

    cfg: ModelConfig
    chip: ChipSpec
    tp: int = 1

    def _table(self) -> _PricingTable:
        # lazy per-instance handle: avoids re-hashing (cfg, chip, tp) on
        # every pricing call (frozen dataclass => cache via object.__setattr__)
        t = self.__dict__.get("_tab_")
        if t is None:
            t = _pricing_table(self.cfg, self.chip, self.tp)
            object.__setattr__(self, "_tab_", t)
        return t

    def _scaled(self, terms, f) -> IterCost:
        time_s, p, e, f_eff, theta = self._table().cost(*terms, f)
        return IterCost(time_s, p * self.tp, e * self.tp, f_eff, theta)

    # -- phase work ---------------------------------------------------------
    def prefill_iter(
        self, n_tok: int, avg_ctx: Optional[float] = None, f: float = None
    ) -> IterCost:
        t = self._table()
        if f is None:
            f = t.f_max
        if n_tok <= 0:
            return IterCost(0.0, t.p_idle * self.tp, 0.0, f, 0.0)
        avg_ctx = float(avg_ctx if avg_ctx is not None else n_tok)
        return self._scaled(t.prefill_terms(n_tok, avg_ctx), f)

    def prefill_chunk_iter(
        self, n_new: int, n_ctx: int = 0, n_reqs: int = 1, f: float = None
    ) -> IterCost:
        """Cost of a partial-prefill iteration: ``n_new`` fresh tokens
        against ``n_ctx`` resident prefix tokens (cache + prior chunks)."""
        t = self._table()
        if f is None:
            f = t.f_max
        if n_new <= 0:
            return IterCost(0.0, t.p_idle * self.tp, 0.0, f, 0.0)
        return self._scaled(t.chunk_terms(n_new, n_ctx, n_reqs), f)

    def decode_iter(self, n_req: int, n_kv: int, f: float = None) -> IterCost:
        t = self._table()
        if f is None:
            f = t.f_max
        if n_req <= 0:
            return IterCost(0.0, t.p_idle * self.tp, 0.0, f, 0.0)
        return self._scaled(t.decode_terms(n_req, n_kv), f)

    def verify_iter(
        self, n_req: int, n_kv: int, k: int, f: float = None
    ) -> IterCost:
        """Cost of one speculative verify forward: ``k + 1`` query rows
        per request against the resident cache (KV streamed once)."""
        t = self._table()
        if f is None:
            f = t.f_max
        if n_req <= 0:
            return IterCost(0.0, t.p_idle * self.tp, 0.0, f, 0.0)
        return self._scaled(t.verify_terms(n_req, n_kv, k), f)

    def draft_iter(
        self, n_req: int, n_kv: int, frac: float, f: float = None
    ) -> IterCost:
        """Cost of one draft-model decode step (a ``frac``-scaled shadow
        of the target's decode work)."""
        t = self._table()
        if f is None:
            f = t.f_max
        if n_req <= 0:
            return IterCost(0.0, t.p_idle * self.tp, 0.0, f, 0.0)
        flops, hbm, pad = t.decode_terms(n_req, n_kv)
        return self._scaled((flops * frac, hbm * frac, pad * frac), f)

    def spec_decode_iter(
        self,
        n_req: int,
        n_kv: int,
        k: int,
        draft_frac: float = 0.05,
        f: float = None,
    ) -> IterCost:
        """One full speculative iteration: ``k + 1`` draft steps (the
        sync step plus ``k`` proposals) serially composed with the
        target's verify forward.  Times and joules add; the reported
        power is the energy-weighted mean and ``f_effective``/``theta``
        are the verify forward's (it dominates both)."""
        f = f if f is not None else self.chip.f_max
        v = self.verify_iter(n_req, n_kv, k, f)
        d = self.draft_iter(n_req, n_kv, draft_frac, f)
        time_s = v.time_s + (k + 1) * d.time_s
        energy = v.energy_j + (k + 1) * d.energy_j
        power = energy / time_s if time_s > 0 else v.power_w
        return IterCost(time_s, power, energy, v.f_effective, v.theta)

    def spec_decode_time(
        self, n_req: int, n_kv: int, k: int, f: float,
        draft_frac: float = 0.05,
    ) -> float:
        return self.spec_decode_iter(n_req, n_kv, k, draft_frac, f).time_s

    def hybrid_iter(
        self,
        n_req: int,
        n_kv: int,
        n_new: int,
        n_ctx: int = 0,
        n_pre_reqs: int = 1,
        f: float = None,
    ) -> IterCost:
        """One mixed iteration on a hybrid instance: a decode step for
        ``n_req`` running requests piggybacking a prefill chunk of
        ``n_new`` tokens (Sarathi-style coalescing). Work composes
        additively; the weight stream is shared (counted once by
        subtracting the duplicated weight bytes)."""
        t = self._table()
        if f is None:
            f = t.f_max
        return self._scaled(
            t.hybrid_terms(n_req, n_kv, n_new, n_ctx, n_pre_reqs), f
        )

    # -- array-native batch twins (struct-of-arrays, bit-identical) --------
    def _finish_batch(self, flops, hbm, pad, f) -> IterCostBatch:
        time_s, p, e, f_eff, theta = self._table().cost_arr(
            flops, hbm, pad, f
        )
        if self.tp != 1:
            p = p * self.tp
            e = e * self.tp
        return IterCostBatch(time_s, p, e, f_eff, theta)

    def decode_iter_batch(self, n_req, n_kv, f=None) -> IterCostBatch:
        """Array twin of :meth:`decode_iter`: element ``i`` is bit-equal
        to ``decode_iter(n_req[i], n_kv[i], f[i])``.  Inputs broadcast."""
        t = self._table()
        n_req, n_kv, f = _batch_args(
            t, (n_req, np.int64), (n_kv, np.int64), (f, np.float64)
        )
        return self._finish_batch(*t.decode_terms_arr(n_req, n_kv), f)

    def verify_iter_batch(self, n_req, n_kv, k, f=None) -> IterCostBatch:
        t = self._table()
        n_req, n_kv, k, f = _batch_args(
            t, (n_req, np.int64), (n_kv, np.int64), (k, np.int64),
            (f, np.float64),
        )
        return self._finish_batch(*t.verify_terms_arr(n_req, n_kv, k), f)

    def draft_iter_batch(self, n_req, n_kv, frac, f=None) -> IterCostBatch:
        t = self._table()
        n_req, n_kv, f = _batch_args(
            t, (n_req, np.int64), (n_kv, np.int64), (f, np.float64)
        )
        flops, hbm, pad = t.decode_terms_arr(n_req, n_kv)
        return self._finish_batch(flops * frac, hbm * frac, pad * frac, f)

    def spec_decode_iter_batch(
        self, n_req, n_kv, k, draft_frac=0.05, f=None
    ) -> IterCostBatch:
        """Array twin of :meth:`spec_decode_iter` (serial verify + k+1
        draft composition, element-wise)."""
        t = self._table()
        n_req, n_kv, k, f = _batch_args(
            t, (n_req, np.int64), (n_kv, np.int64), (k, np.int64),
            (f, np.float64),
        )
        v = self.verify_iter_batch(n_req, n_kv, k, f)
        d = self.draft_iter_batch(n_req, n_kv, draft_frac, f)
        time_s = v.time_s + (k + 1) * d.time_s
        energy = v.energy_j + (k + 1) * d.energy_j
        with np.errstate(divide="ignore", invalid="ignore"):
            power = np.where(
                time_s > 0,
                energy / np.where(time_s > 0, time_s, 1.0),
                v.power_w,
            )
        return IterCostBatch(time_s, power, energy, v.f_effective, v.theta)

    def prefill_iter_batch(self, n_tok, avg_ctx=None, f=None) -> IterCostBatch:
        t = self._table()
        n_tok_a = np.asarray(n_tok, dtype=np.int64)
        ctx = (n_tok_a.astype(np.float64) if avg_ctx is None
               else np.asarray(avg_ctx, dtype=np.float64))
        n_tok_a, ctx, f = _batch_args(
            t, (n_tok_a, np.int64), (ctx, np.float64), (f, np.float64)
        )
        return self._finish_batch(*t.prefill_terms_arr(n_tok_a, ctx), f)

    def prefill_chunk_iter_batch(
        self, n_new, n_ctx=0, n_reqs=1, f=None
    ) -> IterCostBatch:
        t = self._table()
        n_new, n_ctx, n_reqs, f = _batch_args(
            t, (n_new, np.int64), (n_ctx, np.int64), (n_reqs, np.int64),
            (f, np.float64),
        )
        return self._finish_batch(
            *t.chunk_terms_arr(n_new, n_ctx, n_reqs), f
        )

    def hybrid_iter_batch(
        self, n_req, n_kv, n_new, n_ctx=0, n_pre_reqs=1, f=None
    ) -> IterCostBatch:
        t = self._table()
        n_req, n_kv, n_new, n_ctx, n_pre, f = _batch_args(
            t, (n_req, np.int64), (n_kv, np.int64), (n_new, np.int64),
            (n_ctx, np.int64), (n_pre_reqs, np.int64), (f, np.float64),
        )
        return self._finish_batch(
            *t.hybrid_terms_arr(n_req, n_kv, n_new, n_ctx, n_pre), f
        )

    # -- convenience for EcoPred ground truth -------------------------------
    def prefill_time(self, n_tok: int, f: float,
                     avg_ctx: Optional[float] = None) -> float:
        return self.prefill_iter(n_tok, avg_ctx, f).time_s

    def prefill_chunk_time(
        self, n_new: int, n_ctx: int, f: float, n_reqs: int = 1
    ) -> float:
        return self.prefill_chunk_iter(n_new, n_ctx, n_reqs, f).time_s

    def decode_time(self, n_req: int, n_kv: int, f: float) -> float:
        return self.decode_iter(n_req, n_kv, f).time_s

    def idle_power(self) -> float:
        return self.chip.p_idle * self.tp

    def sleep_power(self) -> float:
        """Draw (W) of a parked instance (drained, HBM in self-refresh)."""
        return self.chip.p_sleep * self.tp

    # -- fleet-level efficiency/capacity ratings (EcoScale) -----------------
    def decode_ept_j(
        self, n_req: int = 64, n_kv: int = 32_768, f: Optional[float] = None
    ) -> float:
        """Energy per output token (J) at a reference decode operating
        point.  The autoscaler ranks chips by this to park the most
        expensive instance first and re-admit the cheapest first."""
        f = f if f is not None else self.chip.f_mem_knee
        c = self.decode_iter(n_req, n_kv, f)
        return c.energy_j / max(1, n_req)

    def prefill_ept_j(
        self, n_tok: int = 4_096, f: Optional[float] = None
    ) -> float:
        """Energy per prefilled token (J) at a reference batch."""
        f = f if f is not None else self.chip.f_volt_knee
        c = self.prefill_iter(n_tok, None, f)
        return c.energy_j / max(1, n_tok)

    def prefill_capacity_tok_s(
        self, n_tok: int = 8_192, f: Optional[float] = None
    ) -> float:
        """Sustainable prefill throughput (tokens/s) at frequency ``f``
        (default: max clock) with full batches — the demand-vs-capacity
        denominator of the autoscaler's prefill headroom projection."""
        f = f if f is not None else self.chip.f_max
        c = self.prefill_iter(n_tok, None, f)
        return n_tok / c.time_s if c.time_s > 0 else float("inf")

    # -- capacity -----------------------------------------------------------
    def kv_bytes_per_token(self) -> float:
        return _body_params(self.cfg)[4]

    def kv_transfer_bytes(self, n_tokens: int, page_size: int = 0) -> float:
        """Bytes a P→D migration of an ``n_tokens`` context moves.

        Paged serving transfers whole pages (the block-pool allocator's
        unit of copy), so the context rounds up to its page footprint;
        ``page_size=0`` is the legacy token-granular pricing.  Recurrent
        per-request state rides along either way.
        """
        if page_size > 0 and n_tokens > 0:
            n_tokens = -(-n_tokens // page_size) * page_size
        return (
            n_tokens * self.kv_bytes_per_token()
            + self.state_bytes_per_request()
        )

    def state_bytes_per_request(self) -> float:
        return _body_params(self.cfg)[5]

    def kv_capacity_tokens(self, reserve_frac: float = 0.35) -> int:
        """KV tokens that fit in HBM after weights + activation reserve."""
        total, *_ = _body_params(self.cfg)
        emb = self.cfg.vocab_size * self.cfg.d_model * (
            1 if self.cfg.tie_embeddings else 2
        )
        w = (total + emb) * BF16 / self.tp
        free = self.chip.hbm_bytes * (1 - reserve_frac) - w
        per_tok = max(self.kv_bytes_per_token() / self.tp, 1.0)
        return max(0, int(free / per_tok))


# ---------------------------------------------------------------------------
# U-curve / staircase sweeps (used by benchmarks + offline profiling)
# ---------------------------------------------------------------------------


def energy_frequency_curve(
    hw: HardwareModel, phase: str, n_grid: int = 40, **state
):
    """[(f, time_s, energy_j)] across the chip's frequency range.

    ``state``: prefill -> n_tok (and optional avg_ctx); decode -> n_req,
    n_kv; verify -> n_req, n_kv, k (and optional draft_frac) for the
    speculative multi-token iteration — its U-curve sits at a higher
    sweet-spot frequency than plain decode because the shared KV stream
    amortizes over k+1 query rows.
    """
    out = []
    for f in hw.chip.freq_grid(n_grid):
        if phase == "prefill":
            c = hw.prefill_iter(state["n_tok"], state.get("avg_ctx"), f)
        elif phase == "verify":
            c = hw.spec_decode_iter(
                state["n_req"], state["n_kv"], state["k"],
                state.get("draft_frac", 0.05), f,
            )
        else:
            c = hw.decode_iter(state["n_req"], state["n_kv"], f)
        out.append((f, c.time_s, c.energy_j))
    return out


def sweet_spot(hw: HardwareModel, phase: str, **state) -> float:
    """argmin-energy frequency (the paper's 'sweet spot')."""
    curve = energy_frequency_curve(hw, phase, n_grid=80, **state)
    return min(curve, key=lambda r: r[2])[0]
