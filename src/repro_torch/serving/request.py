"""Request lifecycle + SLO tiers for the P/D disaggregated serving system.

States:  QUEUED_PREFILL -> RUNNING_PREFILL -> TRANSFERRING -> QUEUED_DECODE
         -> RUNNING_DECODE -> FINISHED  (or FAILED on instance loss, after
         which the request is re-queued for prefill — KV state is gone).
         SHED is terminal: tier-aware admission control rejected the
         request at arrival; it was never admitted and runs nowhere.

SLO tiers: each request may carry a tier name (``interactive`` /
``standard`` / ``batch``).  The cluster resolves the name against its
:class:`TierSpec` table at arrival into concrete per-request TTFT/ITL
targets (scales of the cluster's base SLO), a strict cross-tier priority,
an EDF deadline, and the preemption/shedding capabilities.  Untiered
requests (``tier == ""``) resolve to the identity spec, so pre-tier
workloads behave bit-exactly as before.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Phase(enum.Enum):
    QUEUED_PREFILL = "queued_prefill"
    RUNNING_PREFILL = "running_prefill"
    TRANSFERRING = "transferring"
    QUEUED_DECODE = "queued_decode"
    RUNNING_DECODE = "running_decode"
    FINISHED = "finished"
    SHED = "shed"  # rejected by admission control (never admitted)


# ---------------------------------------------------------------------------
# SLO tiers
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class TierSpec:
    """One SLO class: per-tier latency targets + scheduling capabilities.

    ``ttft_scale`` / ``itl_scale`` multiply the cluster's base SLOs (which
    stay model-size dependent, §VI-B), so one tier table serves every
    model setup.  ``priority`` is strict across tiers (0 = most urgent);
    within a tier the engines run EDF on the resolved TTFT deadline.
    ``boosts_queue`` feeds EcoFreq's step-1 queue check: a backlog of
    pure batch work no longer forces ``max(F)``.
    """

    name: str
    priority: int  # 0 = highest; strict across tiers
    ttft_scale: float = 1.0  # × cluster slo_ttft_s
    itl_scale: float = 1.0  # × cluster slo_itl_s
    preemptible: bool = False  # decode may evict under KV/headroom pressure
    sheddable: bool = False  # admission control may reject at arrival
    boosts_queue: bool = True  # waiting work of this tier forces max(F)


INTERACTIVE = TierSpec("interactive", 0, 1.0, 1.0)
STANDARD = TierSpec("standard", 1, 2.5, 2.0)
BATCH = TierSpec(
    "batch", 2, 8.0, 6.0,
    preemptible=True, sheddable=True, boosts_queue=False,
)
# identity spec for untiered (pre-tier) requests: cluster-default SLOs,
# middle priority, no preemption/shedding — exactly the legacy behavior
UNTIERED = TierSpec("", 1, 1.0, 1.0)

DEFAULT_TIERS: Dict[str, TierSpec] = {
    t.name: t for t in (INTERACTIVE, STANDARD, BATCH)
}


@dataclass(slots=True)
class Request:
    rid: int
    arrival_s: float
    prompt_len: int
    decode_len: int  # decode iterations to run (inter-token intervals);
    # total output tokens = decode_len + 1 (the first comes from prefill)
    kind: str = "conversation"  # workload tag (Azure trace: conversation/code)

    # multi-turn trace identity (prefix caching); -1 == standalone request
    conv_id: int = -1
    turn: int = 0

    # SLO tier (resolved by the cluster at arrival when tiers are enabled;
    # "" == untiered legacy request -> identity resolution)
    tier: str = ""
    priority: int = 1  # strict cross-tier priority, 0 = most urgent
    slo_ttft_s: float = -1.0  # resolved per-request targets; <0 = cluster
    slo_itl_s: float = -1.0  # default (untiered / tiers disabled)
    deadline_s: float = math.inf  # absolute TTFT deadline (EDF key)
    preemptible: bool = False
    sheddable: bool = False
    boosts_queue: bool = True

    # lifecycle
    phase: Phase = Phase.QUEUED_PREFILL
    prefill_instance: int = -1
    decode_instance: int = -1
    restarts: int = 0  # instance-failure re-queues
    preemptions: int = 0  # decode evictions (recompute-on-resume)
    # decode tokens generated before the last preemption: on resume the
    # prefill phase recomputes prompt + these tokens (their KV was lost,
    # but the tokens themselves were already delivered — never re-emitted)
    preempt_gen_len: int = 0
    # True from eviction until the resume prefill completes: the next
    # prefill pass is a KV *recompute*, distinct from a failure restart
    # (which resets generation and legitimately re-emits the first token)
    resume_pending: bool = False
    # admission seq inside the current TierQueue (partial-chunk requeues
    # keep it so they resume at the front of their tier class)
    queue_seq: int = -1

    # timestamps (simulation seconds)
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0  # = prefill completion
    t_join_decode: float = -1.0
    t_finish: float = -1.0

    # prefill progress (chunked prefill + prefix cache)
    cached_len: int = 0  # prompt tokens served from the radix prefix cache
    computed_len: int = 0  # prompt tokens prefilled so far (beyond cache)

    # speculative decoding: the request's draft-acceptance propensity
    # (probability a drafted token is accepted; workload-assigned —
    # templated/code-like traffic drafts well, creative chat poorly).
    # < 0 = unknown: the engine substitutes its cluster-level default.
    accept_rate: float = -1.0

    # decode progress
    tokens_out: int = 0  # decode tokens generated so far
    kv_len: int = 0  # resident tokens in the decode instance's cache
    max_itl_s: float = 0.0
    # speculative-decode accounting (all zero for non-spec runs):
    # spec_iters   — multi-token iterations this request participated in
    # spec_drafted — draft tokens proposed for it (spec_iters × k)
    # spec_accepted— drafted tokens accepted *and emitted* (clipped at
    #                the request's own end of stream, so
    #                emitted-via-spec == spec_accepted + spec_iters)
    spec_iters: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0

    # real-engine payloads (None in pure simulation)
    prompt_tokens: Optional[list] = None
    output_tokens: List[int] = field(default_factory=list)
    kv_handoff: Optional[object] = None  # migrating KV cache (P -> D)

    # -- metrics ------------------------------------------------------------
    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.arrival_s

    @property
    def itl_mean_s(self) -> float:
        """Mean inter-token latency over the decode phase (TPOT-style):
        (finish - first_token) / decode tokens. DistServe-style attainment
        compares this against the ITL SLO."""
        if self.decode_len <= 0:
            return 0.0
        return (self.t_finish - self.t_first_token) / self.decode_len

    @property
    def finished(self) -> bool:
        return self.phase == Phase.FINISHED

    @property
    def shed(self) -> bool:
        return self.phase == Phase.SHED

    @property
    def admitted(self) -> bool:
        return self.phase != Phase.SHED

    @property
    def remaining(self) -> int:
        return self.decode_len - self.tokens_out

    @property
    def prefill_remaining(self) -> int:
        """Prompt tokens still to compute (cache hits never cover the last
        token — its logits produce the first output).  After a decode
        preemption the resume prefill also recomputes the KV of the
        already-delivered tokens (``preempt_gen_len``)."""
        return (self.prompt_len + self.preempt_gen_len
                - self.cached_len - self.computed_len)

    @property
    def resuming(self) -> bool:
        """In prefill to *recompute* KV after a preemption — the first
        token was already emitted and must not be re-emitted."""
        return self.resume_pending
