"""EcoFreq — SLO-aware, per-engine-iteration frequency selection (Alg. 1).

One controller per P/D instance. Each invocation (once per engine
iteration, sub-millisecond):

1. **Queue check** — any *waiting* request ⇒ ``max(F)`` to clear backlog.
2. **Phase-specific budget** — prefill ``S = S_P − max(T_waiting)``
   (waiting time is frequency-irrelevant and must be deducted from the
   TTFT budget, Eq. 5); decode ``S = S_D``.
3. **Frequency selection** — lowest ``f ∈ F`` with predicted
   ``T_inference(f) ≤ S``; if none qualifies, ``max(F)``.

The paper runs the controller in a separate process and hides the ~3 ms
NVML apply latency behind the engine's forward; the simulator models the
same overlap via ``apply_overhead_s`` (the *decision* applies this
iteration; the overhead never sits on the critical path). Baseline
controllers (static frequency, power cap, window-interval EcoFreq) live
here too so every evaluated policy shares one interface.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence

import numpy as np

from repro_torch.core import power as P
from repro_torch.core.ecopred import EcoPred
from repro_torch.core.power import ChipSpec


def expected_emitted(accept_rate: float, k: int) -> float:
    """Expected tokens emitted by one speculative iteration.

    With per-token acceptance probability ``p`` and a ``k``-token draft,
    the accepted prefix length is geometric-truncated and the iteration
    always emits the bonus/correction token, so

        E[emitted] = 1 + p + p² + … + p^k.

    ``k == 0`` (speculation off) is exactly 1 — the legacy one token per
    iteration."""
    p = min(max(accept_rate, 0.0), 1.0)
    out, pw = 1.0, 1.0
    for _ in range(k):
        pw *= p
        out += pw
    return out


@dataclass(slots=True)
class BatchInfo:
    """What the engine sends the controller when scheduling a batch (B)."""

    phase: str  # "prefill" | "decode"
    n_tok: int = 0  # prefill: batched *new* prompt tokens this iteration
    n_req: int = 0  # decode: running requests
    n_kv: int = 0  # decode: resident KV tokens
    max_waiting_s: float = 0.0  # prefill: max queue wait within this batch
    n_cached: int = 0  # prefill: resident prefix tokens (cache + chunks)
    # SLO-tier overrides (None = the controller's global SLOs, the exact
    # pre-tier behavior).  When tiers are resolved the engine passes the
    # *tightest binding deadline actually present in the batch*:
    # prefill: min over the batch of (deadline − now); decode: min ITL
    # target over the running requests.
    budget_s: Optional[float] = None  # prefill: tightest remaining budget
    itl_slo_s: Optional[float] = None  # decode: binding ITL target
    # speculative decode (multi-token iterations): k > 0 switches the
    # latency query to the verify model and paces against the ITL target
    # per *emitted* token — one iteration may deliver several accepted
    # tokens, so its wall-time budget is itl_slo × E[emitted], with
    # E[emitted] fed from the engine's per-instance acceptance EWMA.
    # Defaults (0, 1.0) are the exact legacy single-token behavior.
    spec_k: int = 0
    emitted_per_iter: float = 1.0


@dataclass(slots=True)
class SystemState:
    """Instance system state (M): queue + clock."""

    has_waiting: bool = False
    now_s: float = 0.0
    # tier-aware refinement of the step-1 queue check: None = legacy
    # (any waiting request boosts); with tiers resolved, only waiting
    # work whose tier sets ``boosts_queue`` forces max(F) — a backlog of
    # pure batch-tier prompts paces against its own lax deadlines instead.
    has_urgent_waiting: Optional[bool] = None


class FreqController(Protocol):
    def select(self, state: SystemState, batch: BatchInfo) -> float: ...


# ---------------------------------------------------------------------------
# EcoFreq proper
# ---------------------------------------------------------------------------


@dataclass
class EcoFreq:
    """Alg. 1. ``freq_options`` may differ per phase (GH200, Appx. M)."""

    freq_options: Sequence[float]
    predictor: EcoPred
    slo_ttft_s: float
    slo_itl_s: float
    latency_bias_s: float = 0.0  # straggler-mitigation bias (DESIGN.md §7)
    apply_overhead_s: float = 0.003  # overlapped; informational
    # beyond-paper robustness knob: budget headroom covering latency the
    # predictor can't see (KV transfer, decode-join gaps). 1.0 == the
    # paper's exact Alg. 1. Measured (llama-8B@55rps): 0.8 restores ITL
    # attainment 0.85 -> 1.0 for +1.2% energy.
    slo_margin: float = 1.0
    # decision memo: skip the predictor entirely when consecutive
    # iterations present the same quantized state.  Keys are the
    # predictor's own quantile-bin coordinates plus the exact budget, so
    # a hit returns exactly what the ladder scan would have — bit-exact
    # by construction (GBTree predictions are constant within a bin
    # cell).  False = always scan (the pre-memo behavior).
    select_memo: bool = True

    _MEMO_CAP = 4096  # distinct quantized states kept before a reset

    def __post_init__(self):
        self.freq_options = tuple(sorted(set(self.freq_options)))
        self._ladder = np.asarray(self.freq_options)
        self._memo: dict = {}
        self._memo_version = -1
        self.select_memo_hits = 0
        self.select_memo_misses = 0

    @property
    def f_max(self) -> float:
        return self.freq_options[-1]

    def invalidate(self) -> None:
        """Drop memoized decisions.  Behavior-neutral (keys are exact /
        bin-exact), called by engines at preemption/park/wake boundaries
        as belt-and-braces against future key widening."""
        self._memo.clear()

    def budget(self, batch: BatchInfo) -> float:
        if batch.phase == "prefill":
            if batch.budget_s is not None:  # tiered: tightest deadline
                return batch.budget_s * self.slo_margin
            return (self.slo_ttft_s - batch.max_waiting_s) * self.slo_margin
        itl = (
            batch.itl_slo_s if batch.itl_slo_s is not None  # tiered
            else self.slo_itl_s
        )
        if batch.spec_k > 0:
            # multi-token iterations: the SLO binds per *emitted* token,
            # so one iteration's wall-time budget is the binding ITL
            # times the expected yield (acceptance-EWMA-fed)
            itl = itl * max(1.0, batch.emitted_per_iter)
        return itl * self.slo_margin

    def predict(self, f, batch: BatchInfo) -> np.ndarray:
        if batch.phase == "prefill":
            t = self.predictor.predict_prefill(f, batch.n_tok, batch.n_cached)
        elif batch.spec_k > 0:
            t = self.predictor.predict_verify(
                f, batch.n_req, batch.n_kv, batch.spec_k
            )
        else:
            t = self.predictor.predict_decode(f, batch.n_req, batch.n_kv)
        return t + self.latency_bias_s

    def _memo_key(self, s: float, batch: BatchInfo):
        """Quantized decision key, or None when the state isn't keyable.

        Decode/verify states key on the predictor's quantile-bin
        coordinates (predictions are constant within a cell); prefill
        states key on the exact feature tuple (GBLinear is continuous).
        The budget ``s`` enters exactly, so tier deadlines, spec yield
        and margin all self-invalidate through the key."""
        try:
            if batch.phase == "prefill":
                return ("p", batch.n_tok, batch.n_cached, s,
                        self.latency_bias_s)
            if batch.spec_k > 0:
                return ("v",) + self.predictor.verify_bin_key(
                    batch.n_req, batch.n_kv, batch.spec_k
                ) + (s, self.latency_bias_s)
            return ("d",) + self.predictor.decode_bin_key(
                batch.n_req, batch.n_kv
            ) + (s, self.latency_bias_s)
        except (AttributeError, TypeError):
            return None  # non-EcoPred predictor / unfitted bins

    def _scan(self, s: float, batch: BatchInfo) -> float:
        # lowest frequency meeting the budget — one predictor query
        # serves the whole ladder in every phase
        preds = self.predict(self._ladder, batch)
        ok = preds <= s
        if ok.any():
            return self.freq_options[int(np.argmax(ok))]
        return self.f_max

    def select(self, state: SystemState, batch: BatchInfo) -> float:
        # step 1 — queue check: clear backlogged requests timely (tiered:
        # only urgent-tier backlog boosts; batch-tier backlog paces EDF)
        boost = (
            state.has_urgent_waiting
            if state.has_urgent_waiting is not None
            else state.has_waiting
        )
        if boost:
            return self.f_max
        # step 2 — phase-adjusted SLO budget
        s = self.budget(batch)
        if s <= 0.0:
            return self.f_max
        # step 3 — lowest frequency meeting the budget, memoized on the
        # quantized (phase, state-bins, budget) key
        if not self.select_memo:
            return self._scan(s, batch)
        key = self._memo_key(s, batch)
        if key is None:
            return self._scan(s, batch)
        pv = getattr(self.predictor, "version", 0)
        if pv != self._memo_version:
            self._memo.clear()
            self._memo_version = pv
        f = self._memo.get(key)
        if f is not None:
            self.select_memo_hits += 1
            return f
        f = self._scan(s, batch)
        self.select_memo_misses += 1
        if len(self._memo) >= self._MEMO_CAP:
            self._memo.clear()
        self._memo[key] = f
        return f


# ---------------------------------------------------------------------------
# Baseline controllers (paper §VI baselines)
# ---------------------------------------------------------------------------


@dataclass
class StaticFreq:
    """SGLang-<f> baseline: a fixed clock."""

    f: float

    def select(self, state: SystemState, batch: BatchInfo) -> float:
        return self.f


@dataclass
class PowerCapFreq:
    """Power-capped baseline (Appx. H): an indirect frequency upper bound.

    The highest frequency whose *worst-case* (util=1) draw stays below the
    cap — exactly the static behavior the paper criticises: it cannot drop
    the clock at low load nor boost past the cap under pressure.
    """

    chip: ChipSpec
    cap_w: float

    def __post_init__(self):
        # Closed-form inversion of ``P.power(chip, f, 1.0) == cap_w``
        # (no scipy, no iteration).  With x = f/f_max and the DVFS
        # voltage curve V(x), Eq. 1 gives  x·V(x)² = d  where
        # d = (cap_w − p_idle)·V(1)² / (p_elec_max − p_idle):
        # * voltage-floor region (x ≤ x_knee, V ≡ 1): x = d;
        # * above the knee V(x) = a + b·x is affine, so the cap point is
        #   the real root of  b²x³ + 2abx² + a²x − d = 0  in [x_knee, 1].
        c = self.chip
        v1 = P.voltage(c, c.f_max)
        d = (self.cap_w - c.p_idle) * (v1 * v1) / (c.p_elec_max - c.p_idle)
        xk = c.x_volt_knee
        if d <= 0.0:
            x = c.f_min / c.f_max
        elif d <= xk:
            x = d
        else:
            b = c.volt_slope / (1.0 - xk)
            a = 1.0 - c.volt_slope * xk / (1.0 - xk)
            roots = np.roots([b * b, 2.0 * a * b, a * a, -d])
            real = roots[np.abs(roots.imag) < 1e-9].real
            cand = real[real >= xk - 1e-12]
            # x·V(x)² is strictly increasing, so at most one root ≥ knee
            x = float(cand.min()) if cand.size else 1.0
        f = min(max(x * c.f_max, c.f_min), c.f_max)
        # absorb root-finding float error: the cap is an invariant
        for _ in range(4):
            if P.power(c, f, 1.0) <= self.cap_w or f <= c.f_min:
                break
            f = max(c.f_min, f * (1.0 - 1e-9))
        self.f_cap = f

    def select(self, state: SystemState, batch: BatchInfo) -> float:
        return min(self.f_cap, self.chip.f_max)


@dataclass
class IntervalFreq:
    """Window-based EcoFreq (Fig. 20 ablation): re-decides every
    ``interval_s`` seconds instead of every iteration; holds otherwise."""

    base: EcoFreq
    interval_s: float
    _last_t: float = field(default=-1e18, init=False)
    _held: Optional[float] = field(default=None, init=False)

    def select(self, state: SystemState, batch: BatchInfo) -> float:
        if (
            self._held is None
            or state.now_s - self._last_t >= self.interval_s
        ):
            self._held = self.base.select(state, batch)
            self._last_t = state.now_s
        return self._held

    def invalidate(self) -> None:
        """Forward to the wrapped controller.  The *held* decision is
        deliberately kept: dropping it would re-decide off-boundary and
        diverge from a memo-disabled run."""
        base_inv = getattr(self.base, "invalidate", None)
        if base_inv is not None:
            base_inv()
