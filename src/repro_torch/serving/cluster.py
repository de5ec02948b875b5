"""The P/D disaggregated cluster: event-driven serving runtime (Fig. 8).

New requests hit the prefill fleet via round-robin; completed prefills
stream their first token and their KV state migrates to a decode instance
chosen by the decode router (EcoRoute or round-robin); EcoFreq picks each
instance's per-iteration frequency; EcoPred is the shared latency model
that every instance feeds samples back into.

The event loop is a min-heap of timestamped events, so any number of
instances progress asynchronously on one virtual clock. The same loop
drives fault injection (instance loss ⇒ KV gone ⇒ affected requests
re-queue for prefill), elastic scale-out/in, and straggler detection
(per-instance EWMA of EcoPred residuals biases both the local frequency
choice and the router's what-if).
"""
from __future__ import annotations

import copy
import heapq
import inspect
import math
from dataclasses import dataclass, field, replace
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ecofreq import EcoFreq, FreqController, StaticFreq
from repro_torch.core.ecopred import EcoPred, ProfileRanges
from repro_torch.core.ecoroute import (
    CacheAffinityPrefillRouter,
    EcoRoute,
    EnergyAwareEcoRoute,
    EnergyAwarePrefillRouter,
    InstanceProfile,
    InstanceView,
    RoundRobinRouter,
    RouteRequest,
    Router,
    TierAwareEcoRoute,
)
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.core.power import ChipSpec
from repro_torch.serving.autoscale import (
    AutoScaleConfig,
    AutoScaler,
    InstanceSpec,
)
from repro_torch.serving.engine import (
    DecodeEngine,
    HybridEngine,
    PrefillEngine,
    SimBackend,
)
from repro_torch.serving import jitcache
from repro_torch.serving.metrics import RunMetrics
from repro_torch.serving.radixcache import PagedRadixCache, RadixCache
from repro_torch.serving.request import Phase, Request, TierSpec, UNTIERED


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class ClusterConfig:
    model: ModelConfig
    chip: ChipSpec
    n_prefill: int = 2
    n_decode: int = 2
    tp: int = 1  # tensor-parallel degree per instance
    # heterogeneous fleets (EcoScale): explicit per-slot specs override
    # (chip, n_prefill/n_decode, tp, freq_options*) above
    prefill_fleet: Optional[Sequence[InstanceSpec]] = None
    decode_fleet: Optional[Sequence[InstanceSpec]] = None
    # elastic scale-in/out controller; None = fixed fleet (pre-EcoScale)
    autoscale: Optional[AutoScaleConfig] = None
    # SLOs (paper §VI-B: 200/20, 600/60, 1200/120 ms by model size)
    slo_ttft_s: float = 0.6
    slo_itl_s: float = 0.06
    # SLO tiers (multi-tenant): name -> TierSpec table resolved onto each
    # request at arrival (per-request targets = tier scales × the base
    # SLOs above; strict priority + EDF queueing; tier-aware EcoFreq
    # budgets and decode routing).  None = untiered legacy behavior,
    # bit-exact with pre-tier runs.
    slo_tiers: Optional[Dict[str, TierSpec]] = None
    # tier-aware admission control: shed sheddable-tier arrivals when the
    # projected prefill drain already blows admission_ttft_factor × the
    # base (interactive) TTFT SLO, or decode KV free space falls under
    # admission_kv_frac — best-effort work is rejected *before* it can
    # degrade interactive SLOs (only active with slo_tiers)
    admission_control: bool = True
    admission_ttft_factor: float = 1.5
    admission_kv_frac: float = 0.08
    # decode preemption of preemptible-tier requests under KV/headroom
    # pressure, recompute-on-resume; at most max_preemptions evictions
    # per request (anti-starvation).  Only active with slo_tiers.
    preemption: bool = True
    max_preemptions: int = 3
    # policies
    policy: str = "voltana"  # voltana | ecofreq-only | static | powercap
    static_freq: Optional[float] = None  # for policy == "static"
    power_cap_w: Optional[float] = None  # for policy == "powercap"
    freq_options: Optional[Sequence[float]] = None  # default: chip 2-level
    freq_options_prefill: Optional[Sequence[float]] = None  # GH200 split
    control_interval_s: Optional[float] = None  # Fig. 20 window ablation
    delta: float = 500.0  # EcoRoute imbalance threshold (MHz)
    # decision-plane memoization: EcoFreq.select and the routers cache
    # decisions keyed on the quantized iteration state (bit-identical to
    # uncached — keys capture everything the decision reads).  False
    # recomputes every decision; useful for memo-correctness audits.
    decision_memo: bool = True
    # engine limits
    prefill_batch_tokens: int = 8_192
    decode_max_running: int = 512
    kv_capacity_tokens: Optional[int] = None  # default: HBM-derived
    # chunked prefill: prompts are scheduled as chunk iterations under a
    # strict per-iteration token budget (oversized prompts no longer
    # bypass it); False restores legacy whole-prompt FCFS batching
    chunked_prefill: bool = True
    prefill_chunk_tokens: Optional[int] = None  # default: batch budget
    # radix prefix cache (multi-turn / shared-system-prompt reuse) +
    # cache-affinity prefill routing; needs requests with prompt_tokens
    prefix_cache: bool = False
    prefix_cache_capacity: Optional[int] = None  # tokens; default: KV cap
    # paged KV memory: every layer speaks kv_page_size-token pages —
    # decode admission/headroom pad footprints to whole pages, P->D
    # migration prices whole pages, the radix cache matches at page
    # granularity (and, with a real backend, hands out actual pool
    # pages zero-copy).  False = legacy token granularity, bit-exact.
    paged: bool = False
    kv_page_size: int = 16
    # hybrid instances: decode engines that admit prefill chunks between
    # decode steps (local decode join, no KV migration)
    n_hybrid: int = 0
    hybrid_chunk_tokens: int = 2_048
    # speculative decoding: decode instances run draft–verify iterations
    # that emit up to spec_k+1 tokens each (variable-yield scheduling,
    # per-emitted-token EcoFreq pacing, acceptance-aware EcoRoute).  The
    # acceptance realization is a control-plane draw (per-instance
    # stream keyed off the run seed), identical across Sim/Real backends
    # — Real additionally executes the actual draft+verify forwards and
    # rolls rejected pages back.  False = legacy single-token decode,
    # bit-exact.  Hybrid instances never speculate (their iterations
    # already coalesce prefill chunks).
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft_frac: float = 0.05  # draft model cost as a target fraction
    spec_accept_default: float = 0.7  # for requests without accept_rate
    # physics
    noise_sigma: float = 0.02
    transfer_bw: float = 200e9  # P->D KV migration bytes/s
    transfer_const_s: float = 0.002
    # predictor
    predictor: Optional[EcoPred] = None  # share across runs to skip re-fit
    # per-(chip, tp) predictor cache shared across cluster builds; the
    # cluster reads hits and writes misses (keys: InstanceSpec.key)
    predictor_bank: Optional[Dict[Tuple[str, int], EcoPred]] = None
    adapt_every: int = 4_096
    online_adapt: bool = True
    # observability / chaos
    record_traces: bool = False
    straggler_factors: Optional[Dict[int, float]] = None  # decode idx -> x
    seed: int = 0
    # execution backend override: f(kind, idx, hw, seed) -> SimBackend
    # (see repro.serving.realengine.make_real_backend_factory).  When the
    # factory accepts a ``tp`` keyword the cluster passes each instance's
    # InstanceSpec.tp, so heterogeneous fleets carve matching mesh slices
    backend_factory: Optional[Callable] = None

    def __post_init__(self):
        # Fail invalid configs at construction with actionable errors
        # (never via ``assert`` — the checks must survive python -O).
        if self.paged and self.model.kv_dtype == "int8":
            raise ValueError(
                f"ClusterConfig: model '{self.model.name}' has "
                "kv_dtype='int8' but paged=True — the paged KV pool does "
                "not carry int8 scales yet; set paged=False (int8 KV is "
                "supported there) or switch kv_dtype to a float dtype"
            )
        if self.tp < 1:
            raise ValueError(f"ClusterConfig: tp must be >= 1, got {self.tp}")


def build_predictor(
    model: ModelConfig,
    chip: ChipSpec,
    freq_options: Sequence[float],
    tp: int = 1,
    kv_cap: Optional[int] = None,
    max_running: int = 512,
    prefill_tokens: int = 8_192,
    seed: int = 0,
    spec_k: int = 0,
    spec_draft_frac: float = 0.05,
) -> EcoPred:
    """Offline-profile an EcoPred for (model, chip) — reusable across runs.

    The prefill range covers single prompts *larger* than the batch
    budget: FCFS batching admits an oversized prompt whole, so EcoFreq
    consults the predictor there too — extrapolating instead under-
    estimates long-prompt latency and picks clocks that miss TTFT.
    ``spec_k > 0`` additionally profiles the speculative-verify model
    (the cluster does this on demand too; pre-profiling here keeps
    shared predictor fixtures cheap).
    """
    hw = HardwareModel(model, chip, tp)
    cap = kv_cap or max(50_000, hw.kv_capacity_tokens())
    pred = EcoPred(freq_options, seed=seed)
    pred.offline_profile(
        hw,
        ProfileRanges(
            max_tokens=max(prefill_tokens, 32_768),
            max_requests=max_running,
            max_kv_tokens=cap,
            # chunked prefill queries (n_new, n_cached): the resident
            # prefix can be as long as the longest prompt
            max_cached_tokens=max(prefill_tokens, 32_768),
        ),
    )
    if spec_k > 0:
        pred.ensure_verify_profile(
            hw,
            k_options=tuple(sorted({1, 2, 4, 8, spec_k})),
            draft_frac=spec_draft_frac,
            ranges=ProfileRanges(max_requests=max_running,
                                 max_kv_tokens=cap),
        )
    return pred


# ---------------------------------------------------------------------------
# Cluster
# ---------------------------------------------------------------------------

_ARRIVAL, _P_DONE, _JOIN_D, _D_DONE, _CHAOS, _SCALE, _H_DONE = range(7)

# hybrid instances live in their own list; their router-view indices are
# offset so they never collide with prefill/decode indices (which can
# grow via scale-out)
HYBRID_OFF = 1 << 20


class PDCluster:
    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        self._factory_takes_tp: Optional[bool] = None
        self.tiered = cfg.slo_tiers is not None
        fo = tuple(cfg.freq_options or cfg.chip.freq_levels_2)
        fo_p = tuple(cfg.freq_options_prefill or fo)
        self.freq_options = fo
        self._default_spec_p = InstanceSpec(cfg.chip, cfg.tp, fo_p)
        self._default_spec_d = InstanceSpec(cfg.chip, cfg.tp, fo)
        self.prefill_specs: List[InstanceSpec] = list(
            cfg.prefill_fleet
            if cfg.prefill_fleet is not None
            else [self._default_spec_p] * cfg.n_prefill
        )
        self.decode_specs: List[InstanceSpec] = list(
            cfg.decode_fleet
            if cfg.decode_fleet is not None
            else [self._default_spec_d] * cfg.n_decode
        )
        all_specs = self.prefill_specs + self.decode_specs

        def _varied(specs: Sequence[InstanceSpec]) -> bool:
            return len({(s.chip.name, s.tp, s.freqs()) for s in specs}) > 1

        # per-phase variation decides each router (EcoRoute's cross-instance
        # frequency comparison needs one shared ladder *within* the phase);
        # a cross-phase ladder split alone (GH200 F_P vs F_D) stays on the
        # homogeneous paths
        self._varied_prefill = _varied(self.prefill_specs)
        self._varied_decode = _varied(self.decode_specs)
        self.hetero = (
            self._varied_prefill
            or self._varied_decode
            or len({s.key for s in all_specs}) > 1
        )

        # reference hardware model (KV-transfer sizing; model-dependent)
        self.hw = HardwareModel(cfg.model, cfg.chip, cfg.tp)
        self.kv_cap = cfg.kv_capacity_tokens or max(
            50_000, self.hw.kv_capacity_tokens()
        )

        # per-(chip, tp) predictor + hardware-model caches.  A predictor is
        # profiled over the union of every ladder its chip appears with
        # (plus the config-level ladders for the reference chip, so the
        # back-compat `cfg.predictor` path stays exact).
        self._freqs_by_key: Dict[Tuple[str, int], set] = {}
        for s in all_specs:
            self._freqs_by_key.setdefault(s.key, set()).update(s.freqs())
        self._freqs_by_key.setdefault(
            (cfg.chip.name, cfg.tp), set()
        ).update(set(fo) | set(fo_p))
        self._hws: Dict[Tuple[str, int], HardwareModel] = {}
        self._preds: Dict[Tuple[str, int], EcoPred] = {}
        self.predictor = self._pred_for(self.decode_specs[0])

        self.prefill: List[PrefillEngine] = []
        self.decode: List[DecodeEngine] = []
        for i, spec in enumerate(self.prefill_specs):
            self.prefill.append(self._make_prefill(i, spec))
        for i, spec in enumerate(self.decode_specs):
            self.decode.append(self._make_decode(i, spec))
        self.hybrid: List[HybridEngine] = [
            self._make_hybrid(j, self._default_spec_d)
            for j in range(cfg.n_hybrid)
        ]

        self.prefill_router: Router = RoundRobinRouter()
        self._profiles_p: Dict[int, InstanceProfile] = {}
        self._profiles_d: Dict[int, InstanceProfile] = {}
        if cfg.policy == "voltana":
            if self.tiered:
                # tier-aware state-space routing: what-ifs run against
                # each candidate's *binding* ITL target, so interactive
                # traffic prices (and avoids) the clock-up of landing on
                # batch-saturated instances
                for i, spec in enumerate(self.decode_specs):
                    self._profiles_d[i] = self._profile(spec)
                for j in range(len(self.hybrid)):
                    self._profiles_d[HYBRID_OFF + j] = self._profile(
                        self._default_spec_d
                    )
                self.decode_router: Router = TierAwareEcoRoute(
                    self._profiles_d, cfg.slo_itl_s,
                    spec_draft_frac=cfg.spec_draft_frac,
                    memo=cfg.decision_memo,
                )
            elif self._varied_decode:
                for i, spec in enumerate(self.decode_specs):
                    self._profiles_d[i] = self._profile(spec)
                self.decode_router = EnergyAwareEcoRoute(
                    self._profiles_d, cfg.slo_itl_s,
                    spec_draft_frac=cfg.spec_draft_frac,
                    memo=cfg.decision_memo,
                )
            else:
                route_ef = EcoFreq(
                    self.decode_specs[0].freqs(),
                    self._pred_for(self.decode_specs[0]),
                    cfg.slo_ttft_s, cfg.slo_itl_s,
                    select_memo=cfg.decision_memo,
                )
                self.decode_router = EcoRoute(
                    route_ef, cfg.delta, memo=cfg.decision_memo
                )
            if cfg.prefix_cache:
                # cache-affinity placement: hit-rate-weighted what-if over
                # every instance that owns a radix tree
                for i, spec in enumerate(self.prefill_specs):
                    self._profiles_p[i] = self._profile(spec)
                for j in range(len(self.hybrid)):
                    self._profiles_p[HYBRID_OFF + j] = self._profile(
                        self._default_spec_d
                    )
                self.prefill_router = CacheAffinityPrefillRouter(
                    self._profiles_p, cfg.slo_ttft_s,
                    memo=cfg.decision_memo,
                )
            elif self.hetero:
                # the per-instance what-if is also the better prefill
                # balancer whenever any chip identity is in play
                for i, spec in enumerate(self.prefill_specs):
                    self._profiles_p[i] = self._profile(spec)
                for j in range(len(self.hybrid)):
                    self._profiles_p[HYBRID_OFF + j] = self._profile(
                        self._default_spec_d
                    )
                self.prefill_router = EnergyAwarePrefillRouter(
                    self._profiles_p, cfg.slo_ttft_s,
                    memo=cfg.decision_memo,
                )
            if self._varied_decode and not self.tiered:
                for j in range(len(self.hybrid)):
                    self._profiles_d[HYBRID_OFF + j] = self._profile(
                        self._default_spec_d
                    )
        else:
            self.decode_router = RoundRobinRouter()

        self.autoscaler: Optional[AutoScaler] = (
            AutoScaler(cfg.autoscale, self) if cfg.autoscale else None
        )

        # observers notified when an engine is created *after*
        # construction (chaos scale-out): loopprof registers here so
        # mid-run spawns are instrumented like the originals
        self._spawn_hooks: List[Callable] = []

        # event loop state: heap entries are (t, (seq << 3) | kind, data)
        # — seq/kind packed into one int so each event is a 3-tuple with
        # a single integer tie-break instead of a 4-tuple + counter object
        self._heap: List[tuple] = []
        self._eseq = 0
        self._prof = None  # LoopProfile attached by loopprof.install()
        self.now = 0.0
        self.requests: List[Request] = []
        self._bias_ewma: Dict[int, float] = {}
        self._arrived_tokens = 0

    # -- construction -------------------------------------------------------
    def _notify_spawn(self, eng) -> None:
        """Run registered spawn observers on a freshly created engine
        (scale-out path): profilers wrap its backend/controller exactly
        as they wrapped the construction-time fleet."""
        for hook in self._spawn_hooks:
            hook(eng)

    def _hw_for(self, spec: InstanceSpec) -> HardwareModel:
        if spec.key not in self._hws:
            self._hws[spec.key] = HardwareModel(
                self.cfg.model, spec.chip, spec.tp
            )
        return self._hws[spec.key]

    def _pred_for(self, spec: InstanceSpec) -> EcoPred:
        key = spec.key
        if key in self._preds:
            return self._preds[key]
        c = self.cfg
        bank = c.predictor_bank
        if bank is not None and key in bank:
            pred = bank[key]
        elif c.predictor is not None and key == (c.chip.name, c.tp):
            pred = c.predictor
        else:
            hw = self._hw_for(spec)
            kv_cap = c.kv_capacity_tokens or max(
                50_000, hw.kv_capacity_tokens()
            )
            pred = build_predictor(
                c.model, spec.chip, sorted(self._freqs_by_key[key]),
                spec.tp, kv_cap, c.decode_max_running,
                c.prefill_batch_tokens, c.seed,
            )
            if bank is not None:
                bank[key] = pred
        pred.adapt_every = c.adapt_every
        pred.online_enabled = c.online_adapt
        if c.spec_decode:
            # idempotent: bank-shared predictors profile the verify
            # model once; spec_decode=False never touches it
            hw = self._hw_for(spec)
            kv_cap = c.kv_capacity_tokens or max(
                50_000, hw.kv_capacity_tokens()
            )
            pred.ensure_verify_profile(
                hw,
                k_options=tuple(sorted({1, 2, 4, 8, c.spec_k})),
                draft_frac=c.spec_draft_frac,
                ranges=ProfileRanges(
                    max_requests=c.decode_max_running,
                    max_kv_tokens=kv_cap,
                ),
            )
        self._preds[key] = pred
        return pred

    def _profile(self, spec: InstanceSpec) -> InstanceProfile:
        c = self.cfg
        ef = EcoFreq(
            spec.freqs(), self._pred_for(spec), c.slo_ttft_s, c.slo_itl_s,
            select_memo=c.decision_memo,
        )
        return InstanceProfile(spec.chip, ef, self._hw_for(spec))

    def _kv_cap_for(self, spec: InstanceSpec) -> int:
        if self.cfg.kv_capacity_tokens:
            return self.cfg.kv_capacity_tokens
        return max(50_000, self._hw_for(spec).kv_capacity_tokens())

    def _controller(
        self, freq_options: Sequence[float], predictor: EcoPred,
        chip: ChipSpec,
    ) -> FreqController:
        c = self.cfg
        if c.policy == "static":
            assert c.static_freq is not None
            return StaticFreq(c.static_freq)
        if c.policy == "powercap":
            from repro_torch.core.ecofreq import PowerCapFreq

            assert c.power_cap_w is not None
            return PowerCapFreq(chip, c.power_cap_w)
        ef = EcoFreq(freq_options, predictor, c.slo_ttft_s, c.slo_itl_s,
                     select_memo=c.decision_memo)
        if c.control_interval_s:
            from repro_torch.core.ecofreq import IntervalFreq

            return IntervalFreq(ef, c.control_interval_s)
        return ef

    def _instance_seed(self, phase: str, idx: int) -> int:
        """Decorrelated per-instance noise seed.  The old affine scheme
        (``seed*101 + idx`` / ``seed*211 + idx``) collapsed at ``seed=0``:
        prefill-i and decode-i shared one stream, so every instance pair
        saw identical measurement noise.  SeedSequence mixing keys each
        (run seed, phase, slot) to an independent stream."""
        code = {"prefill": 1, "decode": 2, "hybrid": 3, "spec": 4}[phase]
        ss = np.random.SeedSequence([self.cfg.seed, code, idx])
        return int(ss.generate_state(1, np.uint64)[0])

    def _cache_for(self, spec: InstanceSpec) -> Optional[RadixCache]:
        if not self.cfg.prefix_cache:
            return None
        cap = self.cfg.prefix_cache_capacity or self._kv_cap_for(spec)
        if self.cfg.paged:
            return PagedRadixCache(cap, self.cfg.kv_page_size)
        return RadixCache(cap)

    def _bind_backend_cache(self, backend, cache) -> None:
        """Give a paged real backend the engine's radix cache so its
        nodes can hold pool page refs (no-op for Sim backends)."""
        if cache is None:
            return
        bind = getattr(backend, "bind_prefix_cache", None)
        if bind is not None:
            bind(cache)

    def _spawn_backend(self, kind: str, idx: int, hw, seed: int,
                       spec: InstanceSpec):
        """Call the user's backend factory; factories that take a ``tp``
        keyword (``make_real_backend_factory``) get the instance's
        tensor-parallel degree so their mesh slice matches what the cost
        model already assumes.  Legacy 4-arg factories keep working."""
        f = self.cfg.backend_factory
        if self._factory_takes_tp is None:
            try:
                ps = inspect.signature(f).parameters
                self._factory_takes_tp = "tp" in ps or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in ps.values()
                )
            except (TypeError, ValueError):  # builtins, exotic callables
                self._factory_takes_tp = False
        if self._factory_takes_tp:
            return f(kind, idx, hw, seed, tp=spec.tp)
        return f(kind, idx, hw, seed)

    def _make_prefill(self, idx: int, spec: InstanceSpec) -> PrefillEngine:
        c = self.cfg
        hw = self._hw_for(spec)
        pred = self._pred_for(spec)
        seed = self._instance_seed("prefill", idx)
        if c.backend_factory is not None:
            backend = self._spawn_backend("prefill", idx, hw, seed, spec)
        else:
            backend = SimBackend(hw, c.noise_sigma, seed=seed)
        eng = PrefillEngine(
            idx=idx,
            backend=backend,
            controller=self._controller(spec.freqs(), pred, spec.chip),
            predictor=pred,
            max_batch_tokens=c.prefill_batch_tokens,
            record_trace=c.record_traces,
            chunk_tokens=(
                (c.prefill_chunk_tokens or c.prefill_batch_tokens)
                if c.chunked_prefill else None
            ),
            cache=self._cache_for(spec),
        )
        self._bind_backend_cache(backend, eng.cache)
        return eng

    def _make_decode(self, idx: int, spec: InstanceSpec) -> DecodeEngine:
        c = self.cfg
        hw = self._hw_for(spec)
        pred = self._pred_for(spec)
        slow = (c.straggler_factors or {}).get(idx, 1.0)
        seed = self._instance_seed("decode", idx)
        if c.backend_factory is not None:
            backend = self._spawn_backend("decode", idx, hw, seed, spec)
            backend.slow_factor = slow
        else:
            backend = SimBackend(
                hw, c.noise_sigma, seed=seed, slow_factor=slow,
            )
        return DecodeEngine(
            idx=idx,
            backend=backend,
            controller=self._controller(spec.freqs(), pred, spec.chip),
            predictor=pred,
            max_running=c.decode_max_running,
            kv_capacity_tokens=self._kv_cap_for(spec),
            record_trace=c.record_traces,
            preempt_cap=self._preempt_cap(),
            page_size=c.kv_page_size if c.paged else 0,
            spec_k=c.spec_k if c.spec_decode else 0,
            spec_draft_frac=c.spec_draft_frac,
            spec_accept_default=c.spec_accept_default,
            spec_seed=self._instance_seed("spec", idx),
        )

    def _preempt_cap(self) -> int:
        c = self.cfg
        return c.max_preemptions if (self.tiered and c.preemption) else 0

    def _make_hybrid(self, j: int, spec: InstanceSpec) -> HybridEngine:
        c = self.cfg
        hw = self._hw_for(spec)
        pred = self._pred_for(spec)
        seed = self._instance_seed("hybrid", j)
        if c.backend_factory is not None:
            backend = self._spawn_backend("hybrid", j, hw, seed, spec)
        else:
            backend = SimBackend(hw, c.noise_sigma, seed=seed)
        eng = HybridEngine(
            idx=HYBRID_OFF + j,
            backend=backend,
            controller=self._controller(spec.freqs(), pred, spec.chip),
            predictor=pred,
            max_running=c.decode_max_running,
            kv_capacity_tokens=self._kv_cap_for(spec),
            record_trace=c.record_traces,
            chunk_tokens=c.hybrid_chunk_tokens,
            cache=self._cache_for(spec),
            preempt_cap=self._preempt_cap(),
            page_size=c.kv_page_size if c.paged else 0,
        )
        self._bind_backend_cache(backend, eng.cache)
        return eng

    # -- event helpers --------------------------------------------------------
    def _push(self, t: float, kind: int, data) -> None:
        # kinds live in the low 3 bits of the packed key; a kind outside
        # that range would silently corrupt FIFO ordering, so guard it
        # with a real exception (survives ``python -O``)
        if kind & ~7:
            raise ValueError(
                f"event kind {kind} does not fit the packed 3-bit "
                f"key (expected 0..7)"
            )
        s = self._eseq
        self._eseq = s + 1
        heapq.heappush(self._heap, (t, (s << 3) | kind, data))

    def schedule_failure(self, t: float, phase: str, idx: int) -> None:
        self._push(t, _CHAOS, ("fail", phase, idx))

    def schedule_scale_out(self, t: float, phase: str = "decode") -> None:
        self._push(t, _CHAOS, ("scale_out", phase, None))

    # -- autoscaler hooks ----------------------------------------------------
    def pop_arrived_tokens(self) -> int:
        """Prompt tokens arrived since the last autoscale tick."""
        n = self._arrived_tokens
        self._arrived_tokens = 0
        return n

    def on_readmit(self, phase: str, eng) -> None:
        """A parked instance came back: restart its iteration loop."""
        if not eng.busy:
            if phase == "prefill":
                self._kick_prefill(eng)
            else:
                self._kick_decode(eng)

    # -- instance kicks -------------------------------------------------------
    def _kick_prefill(self, e: PrefillEngine) -> None:
        started = e.start_iteration(self.now)
        if started is not None:
            dt, _ = started
            self._push(self.now + dt, _P_DONE, e.idx)

    def _kick_decode(self, e: DecodeEngine) -> None:
        started = e.start_iteration(self.now)
        # KV-pressure evictions happen at the iteration boundary inside
        # start_iteration's admit pass; recompute-on-resume via prefill
        for r in e.take_preempted():
            self._route_prefill(r)
        if started is not None:
            dt, _ = started
            self._push(self.now + dt, _D_DONE, e.idx)

    def _kick_hybrid(self, e: HybridEngine) -> None:
        started = e.start_iteration(self.now)
        for r in e.take_preempted():
            self._route_prefill(r)
        if started is not None:
            dt, _ = started
            self._push(self.now + dt, _H_DONE, e.idx - HYBRID_OFF)

    # -- SLO tiers: resolution + admission control ---------------------------
    def _resolve_tier(self, r: Request) -> None:
        """Resolve the request's tier name into concrete per-request SLO
        targets, priority, EDF deadline, and capabilities (no-op when
        tiers are disabled — untiered legacy behavior)."""
        if not self.tiered:
            return
        spec = self.cfg.slo_tiers.get(r.tier, UNTIERED)
        r.priority = spec.priority
        r.slo_ttft_s = spec.ttft_scale * self.cfg.slo_ttft_s
        r.slo_itl_s = spec.itl_scale * self.cfg.slo_itl_s
        r.deadline_s = r.arrival_s + r.slo_ttft_s
        r.preemptible = spec.preemptible
        r.sheddable = spec.sheddable
        r.boosts_queue = spec.boosts_queue

    def _should_shed(self, r: Request) -> bool:
        """Tier-aware admission: reject a sheddable-tier arrival while
        the cluster is under interactive pressure — best-effort work
        sheds *before* it can queue ahead of strict-SLO traffic."""
        if not (self.tiered and self.cfg.admission_control and r.sheddable):
            return False
        c = self.cfg
        # decode KV pressure: free share across the alive decode fleet
        cap = free = 0
        for e in self.decode + self.hybrid:
            if e.alive:
                cap += e.kv_capacity_tokens
                free += max(0, e.kv_headroom)
        if cap and free < c.admission_kv_frac * cap:
            return True
        # prefill backlog: best projected *existing* queue drain (max
        # clock) across placeable instances vs the strictest (base) TTFT
        # budget.  The arrival's own prompt is deliberately excluded —
        # a bulk prompt on an idle cluster harms nobody (EDF + chunking
        # bound the stall it can inject to one chunk); what sheds is the
        # backlog best-effort work has already piled up.
        budget = c.admission_ttft_factor * c.slo_ttft_s
        best = math.inf
        for e in self.prefill:
            if e.alive and e.accepting:
                t = max(0.0, e.busy_until - self.now) if e.busy else 0.0
                if e.queued_tokens:
                    t += float(e.predictor.predict_prefill(
                        self.prefill_specs[e.idx].f_max, e.queued_tokens,
                    )[0])
                best = min(best, t)
        for h in self.hybrid:
            if h.alive and h.accepting:
                t = 0.0
                if h.queued_tokens:
                    t = float(h.predictor.predict_prefill(
                        self._default_spec_d.f_max, h.queued_tokens,
                    )[0])
                best = min(best, t)
        # a fully parked/drained fleet is absent pressure, not infinite
        # pressure: admit and let the autoscaler's wake path re-admit
        # capacity rather than shedding into idle slots
        return math.isfinite(best) and best > budget

    # -- routing --------------------------------------------------------------
    def _match_len(self, eng, req: Request) -> int:
        if eng.cache is None or not req.prompt_tokens:
            return 0
        return eng.cache.match_len(req.prompt_tokens)

    def _route_prefill(self, req: Request) -> None:
        req.cached_len = req.computed_len = 0  # (re-)entering prefill
        if self.autoscaler is not None:
            self.autoscaler.maybe_wake_prefill(self.now, req.prompt_len)
        views = [
            InstanceView(
                e.idx, len(e.queue), e.queued_tokens, alive=e.alive,
                accepting=e.accepting,
                busy_remaining_s=(
                    max(0.0, e.busy_until - self.now) if e.busy else 0.0
                ),
                cached_len=self._match_len(e, req),
            )
            for e in self.prefill
        ]
        views += [
            InstanceView(
                h.idx, len(h.pqueue), h.queued_tokens, alive=h.alive,
                accepting=h.accepting,
                cached_len=self._match_len(h, req),
            )
            for h in self.hybrid
        ]
        idx = self.prefill_router.route(views, self._route_req(req))
        if idx >= HYBRID_OFF:
            eng = self.hybrid[idx - HYBRID_OFF]
            eng.enqueue_prefill(req, self.now)
            if not eng.busy:
                self._kick_hybrid(eng)
            return
        eng = self.prefill[idx]
        eng.enqueue(req, self.now)
        if not eng.busy:
            self._kick_prefill(eng)

    def _route_req(self, req: Request) -> RouteRequest:
        """Router view of the request: KV it brings (prompt + recomputed
        context after a preemption), its resolved tier target, and its
        draft-acceptance propensity (the acceptance what-if axis)."""
        return RouteRequest(
            req.prompt_len + req.tokens_out,
            itl_slo_s=req.slo_itl_s if req.slo_itl_s > 0 else None,
            accept_rate=(
                (req.accept_rate if req.accept_rate >= 0.0
                 else self.cfg.spec_accept_default)
                if self.cfg.spec_decode else None
            ),
        )

    def _route_decode(self, req: Request) -> None:
        if self.autoscaler is not None:
            self.autoscaler.maybe_wake_decode(self.now, req.prompt_len)
        views = [
            InstanceView(
                e.idx,
                e.n_req,
                e.n_kv,
                has_waiting=len(e.waiting) > 0,
                alive=e.alive,
                accepting=e.accepting,
                kv_headroom=e.kv_headroom,
                latency_bias_s=self._bias_ewma.get(e.idx, 0.0),
                binding_itl_s=e.binding_itl_s,
                spec_k=e.spec_k,
                accept_ewma=e.accept_ewma if e.spec_k > 0 else None,
            )
            for e in self.decode
        ]
        views += [
            InstanceView(
                h.idx, h.n_req, h.n_kv,
                has_waiting=len(h.waiting) > 0,
                alive=h.alive, accepting=h.accepting,
                kv_headroom=h.kv_headroom,
                binding_itl_s=h.binding_itl_s,
            )
            for h in self.hybrid
        ]
        idx = self.decode_router.route(views, self._route_req(req))
        # KV migration latency (context KV bytes over the transfer fabric;
        # a preemption resume re-transfers prompt + regenerated context;
        # paged serving copies whole pages, so the price rounds up too).
        # TP-sharded instances move the handoff per shard: the KV cache is
        # head-sharded across the slice, so tp disjoint shard gathers ride
        # tp parallel links — per-link bytes are 1/tp of the context
        # (tp=1 keeps the legacy pricing bit-exact)
        bytes_ = self.hw.kv_transfer_bytes(
            req.prompt_len + req.tokens_out,
            page_size=self.cfg.kv_page_size if self.cfg.paged else 0,
        )
        lanes = max(1, self.hw.tp)
        dt = self.cfg.transfer_const_s + bytes_ / (
            lanes * self.cfg.transfer_bw
        )
        self._push(self.now + dt, _JOIN_D, (req, idx))

    # -- straggler signal -------------------------------------------------------
    def _update_bias(self, idx: int, measured: float, predicted: float):
        prev = self._bias_ewma.get(idx, 0.0)
        self._bias_ewma[idx] = 0.9 * prev + 0.1 * (measured - predicted)

    # -- main loop ----------------------------------------------------------
    # -- event drain ---------------------------------------------------------
    def _drain(self, pending: int, max_time_s: float) -> None:
        """Hot event loop: pop → dispatch until drained or timed out.
        Local bindings keep the per-event overhead to one heappop, one
        mask, and one method call."""
        heap = self._heap
        pop = heapq.heappop
        handle = self._handle_event
        while heap and pending > 0:
            t, key, data = pop(heap)
            if t > max_time_s:
                break
            self.now = t
            pending += handle(key & 7, data)

    def _drain_profiled(self, pending: int, max_time_s: float,
                        prof) -> None:
        """`_drain` with per-event accounting: heap pops land in
        ``prof.queue_s``; handler wall not claimed by the installed
        probes (start/finish/route wrappers) lands in
        ``prof.bookkeeping_s``.  Kept separate so the unprofiled loop
        pays zero timer cost."""
        heap = self._heap
        pop = heapq.heappop
        handle = self._handle_event
        pc = perf_counter
        while True:
            q0 = pc()
            if not (heap and pending > 0):
                break
            t, key, data = pop(heap)
            prof.queue_s += pc() - q0
            if t > max_time_s:
                break
            self.now = t
            probed0 = (prof.start_total_s + prof.finish_total_s
                       + prof.route_s)
            b0 = pc()
            pending += handle(key & 7, data)
            body = pc() - b0
            prof.bookkeeping_s += max(
                0.0,
                body - (prof.start_total_s + prof.finish_total_s
                        + prof.route_s - probed0),
            )

    def _handle_event(self, kind: int, data) -> int:
        """Dispatch one event; returns the change to the pending-request
        count (≤ 0).  Branches ordered hottest-first (decode iterations
        dominate steady state)."""
        if kind == _D_DONE:
            eng = self.decode[data]
            if not eng.alive:
                return 0
            measured = eng._iter_cost.time_s
            pred = eng.predicted_iter_s(
                eng._iter_f
            ) if eng.running else measured
            self._update_bias(eng.idx, measured, pred)
            done = eng.finish_iteration(self.now)
            self._kick_decode(eng)
            return -len(done)

        if kind == _P_DONE:
            eng = self.prefill[data]
            if not eng.alive:
                return 0
            for r in eng.finish_iteration(self.now):
                self._route_decode(r)
            self._kick_prefill(eng)
            return 0

        if kind == _JOIN_D:
            req, idx = data
            eng = (
                self.hybrid[idx - HYBRID_OFF]
                if idx >= HYBRID_OFF else self.decode[idx]
            )
            if not eng.alive:  # died while KV was in flight
                req.restarts += 1
                req.tokens_out = 0
                req.kv_len = 0
                req.preempt_gen_len = 0
                req.resume_pending = False
                req.output_tokens = []  # re-prefill re-emits
                self._route_prefill(req)
                return 0
            eng.unpark(self.now)  # KV landed after the drain finished
            eng.enqueue(req)
            if not eng.busy:
                if idx >= HYBRID_OFF:
                    self._kick_hybrid(eng)
                else:
                    self._kick_decode(eng)
            return 0

        if kind == _ARRIVAL:
            self._resolve_tier(data)
            if self._should_shed(data):
                data.phase = Phase.SHED
                return -1
            self._arrived_tokens += data.prompt_len
            self._route_prefill(data)
            return 0

        if kind == _H_DONE:
            eng = self.hybrid[data]
            if not eng.alive:
                return 0
            done = eng.finish_iteration(self.now)
            self._kick_hybrid(eng)
            return -len(done)

        if kind == _CHAOS:
            action, phase, idx = data
            if action == "fail":
                if phase == "decode":
                    lost = self.decode[idx].fail()
                elif phase == "hybrid":
                    lost = self.hybrid[idx].fail()
                else:
                    eng = self.prefill[idx]
                    eng.alive = False
                    eng.release_locks()
                    lost = list(eng.current_batch) + list(eng.queue)
                    eng.backend.abort_prefill(lost)
                    eng.current_batch = []
                    eng._takes = []
                    eng.queue.clear()
                    for r in lost:
                        r.restarts += 1
                for r in lost:  # KV lost: back through prefill
                    r.tokens_out = 0
                    r.kv_len = 0
                    r.preempt_gen_len = 0
                    r.resume_pending = False
                    r.output_tokens = []  # re-prefill re-emits
                    self._route_prefill(r)
            elif action == "scale_out":
                if phase == "decode":
                    spec = self._default_spec_d
                    idx = len(self.decode)
                    self.decode_specs.append(spec)
                    eng = self._make_decode(idx, spec)
                    self.decode.append(eng)
                    if self._profiles_d:
                        self._profiles_d[idx] = self._profile(spec)
                else:
                    spec = self._default_spec_p
                    idx = len(self.prefill)
                    self.prefill_specs.append(spec)
                    eng = self._make_prefill(idx, spec)
                    self.prefill.append(eng)
                    if self._profiles_p:
                        self._profiles_p[idx] = self._profile(spec)
                self._notify_spawn(eng)
            return 0

        # _SCALE: pending > 0 is guaranteed by the drain guard and
        # autoscale steps never retire requests, so re-arm unconditionally
        self.autoscaler.step(self.now)
        self._push(
            self.now + self.cfg.autoscale.interval_s, _SCALE, None,
        )
        return 0

    def run(
        self,
        requests: List[Request],
        max_time_s: float = 1e7,
    ) -> RunMetrics:
        self.requests = requests
        for r in requests:
            # defensive lifecycle reset: users legitimately re-run the same
            # workload objects across policies
            r.phase = Phase.QUEUED_PREFILL
            r.tokens_out = 0
            r.kv_len = 0
            r.restarts = 0
            r.cached_len = 0
            r.computed_len = 0
            r.max_itl_s = 0.0
            r.output_tokens = []
            r.t_prefill_start = -1.0
            r.t_first_token = r.t_finish = r.t_join_decode = -1.0
            # tier state is re-resolved per run (the same workload is
            # legitimately served tiered and untiered across arms)
            r.priority = 1
            r.slo_ttft_s = r.slo_itl_s = -1.0
            r.deadline_s = math.inf
            r.preemptible = r.sheddable = False
            r.boosts_queue = True
            r.preemptions = 0
            r.preempt_gen_len = 0
            r.resume_pending = False
            # speculative-decode accounting (accept_rate is workload
            # identity, not lifecycle — it survives across runs)
            r.spec_iters = 0
            r.spec_drafted = 0
            r.spec_accepted = 0
            self._push(r.arrival_s, _ARRIVAL, r)
        pending = len(requests)
        self._arrived_tokens = 0
        # compile telemetry: any XLA compile between here and run end is
        # a recompile charged to this run (zero for pure-Sim backends; a
        # warmed real-backend cluster must also report zero steady-state)
        compiles0 = jitcache.compile_count()
        if self.autoscaler is not None:
            self._push(self.cfg.autoscale.interval_s, _SCALE, None)

        if self._prof is not None:
            self._drain_profiled(pending, max_time_s, self._prof)
        else:
            self._drain(pending, max_time_s)

        end = self.now
        energies = []
        for e in self.prefill + self.decode + self.hybrid:
            # emit any deferred real-backend tokens before the request
            # snapshot below; dead instances are skipped — their pending
            # ids belong to streams that restarted elsewhere
            if e.alive:
                e.backend.flush()
            e.close_park(end)
            e.energy.span_s = end
            energies.append(e.energy)
        hits = lookups = 0
        for e in self.prefill + self.hybrid:
            if e.cache is not None:
                hits += e.cache.hit_tokens
                lookups += e.cache.lookup_tokens
        return RunMetrics(
            # snapshot: callers legitimately re-run the same Request
            # objects under another policy arm, which resets them in
            # place — metrics of *this* run must not silently change
            requests=[copy.copy(r) for r in requests],
            instances=energies,
            slo_ttft_s=self.cfg.slo_ttft_s,
            slo_itl_s=self.cfg.slo_itl_s,
            duration_s=end,
            prefix_hit_rate=(hits / lookups) if lookups else None,
            recompiles=jitcache.compile_count() - compiles0,
        )
