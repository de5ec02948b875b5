"""P/D instance engines + execution backends.

One engine class per phase; the *control plane* (continuous batching,
EcoFreq query, EcoPred recording, energy integration) is identical across
backends. Backends provide the iteration's latency/energy ground truth and
— for the real-JAX backend — the actual tokens:

* :class:`SimBackend` — the roofline-calibrated
  :class:`~repro.core.hwmodel.HardwareModel` plus multiplicative lognormal
  measurement noise. Used for the paper-scale benchmarks.
* :class:`RealBackend` (``repro.serving.realengine``) — actual JAX
  forwards of a reduced model; the virtual clock still advances by the
  hardware model's time (CPU wall time is meaningless for TPU SLOs), so
  controller behavior is identical while tokens are real.

Decode iterations have **variable yield**: with speculative decoding
(``spec_k > 0``) one draft–verify iteration emits the accepted draft
prefix plus a bonus token (1..k+1 tokens per request).  The acceptance
*realization* is drawn by the engine from a seeded stream — a
control-plane decision shared by both backends, which is what keeps
Sim==Real parity exact through speculation — while the backends price
(Sim) or actually execute (Real) the draft steps + multi-token verify.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.ecofreq import (
    BatchInfo,
    FreqController,
    SystemState,
    expected_emitted,
)
from repro_torch.core.ecopred import EcoPred
from repro_torch.core.hwmodel import HardwareModel, IterCost
from repro_torch.serving.metrics import InstanceEnergy
from repro_torch.serving.radixcache import RadixCache
from repro_torch.serving.request import Phase, Request


# ---------------------------------------------------------------------------
# Deadline-aware queue (strict priority across tiers, EDF within a tier)
# ---------------------------------------------------------------------------


class TierQueue:
    """Request queue ordered by (priority, deadline, admission seq).

    Strict priority across tiers, earliest-deadline-first within a tier,
    admission order as the final tie-break.  Untiered requests all carry
    ``priority=1, deadline=+inf``, so the order degenerates to exact
    FCFS — pre-tier runs are bit-identical.

    A request re-entering after a *partial* chunk iteration keeps its
    original admission seq (``requeue``), so it resumes ahead of
    same-key later arrivals — the chunked-prefill front-of-queue
    contract.  A fresh ``append`` (arrival, failure restart, preemption
    resume) draws a new seq and joins at the back of its (priority,
    deadline) class.
    """

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._urgent = 0  # queued requests whose tier boosts EcoFreq

    def _push(self, r: Request, seq: int) -> None:
        r.queue_seq = seq  # carried on the request: O(1) memory per queue
        heapq.heappush(self._heap, (r.priority, r.deadline_s, seq, r))
        if r.boosts_queue:
            self._urgent += 1

    def append(self, r: Request) -> None:
        self._push(r, next(self._seq))

    def requeue(self, rs: List[Request]) -> None:
        """Partially-processed work back in, keeping admission order."""
        for r in rs:
            self._push(
                r, r.queue_seq if r.queue_seq >= 0 else next(self._seq)
            )

    def peek(self) -> Request:
        return self._heap[0][3]

    def popleft(self) -> Request:
        r = heapq.heappop(self._heap)[3]
        if r.boosts_queue:
            self._urgent -= 1
        return r

    def clear(self) -> None:
        self._heap.clear()
        self._urgent = 0

    @property
    def has_urgent(self) -> bool:
        """Any queued request whose tier boosts the EcoFreq queue check
        (== ``bool(queue)`` for untiered workloads)."""
        return self._urgent > 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self) -> Iterator[Request]:
        return (e[3] for e in self._heap)


def _batch_budget_s(batch: List[Request], now: float) -> Optional[float]:
    """Tightest remaining TTFT budget in the batch (EcoFreq tier hook);
    None when any deadline is unresolved (untiered -> legacy formula)."""
    b = math.inf
    for r in batch:
        if not math.isfinite(r.deadline_s):
            return None
        b = min(b, r.deadline_s - now)
    return b if batch else None


def _binding_itl_s(running: List[Request]) -> Optional[float]:
    """Binding (minimum) resolved ITL target across the running batch;
    None when any request is untiered (legacy global-SLO behavior)."""
    b = math.inf
    for r in running:
        if r.slo_itl_s <= 0:
            return None
        b = min(b, r.slo_itl_s)
    return b if running else None


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class SimBackend:
    """Latency/energy from the hardware model with measurement noise."""

    def __init__(self, hw: HardwareModel, noise_sigma: float = 0.02,
                 seed: int = 0, slow_factor: float = 1.0,
                 batch_pricing: bool = False):
        self.hw = hw
        self.noise_sigma = noise_sigma
        self.slow_factor = slow_factor  # straggler injection (>1 == slow)
        self.batch_pricing = batch_pricing  # price via the array twins
        self._rng = np.random.default_rng(seed)
        self.n_iters = 0  # total iterations executed (perf telemetry)
        # per-call Generator.normal() + scalar exp dominate pricing
        # overhead, so noise factors are precomputed in blocks: the
        # generator fills a block from the same bit stream it would
        # consume one draw at a time, and vectorized np.exp is verified
        # bit-equal to the scalar ufunc across the full domain here
        # (tests/test_hwmodel_batch.py pins both), so the noise sequence
        # is bit-identical to per-call draws
        self._noise_blk = np.empty(0)
        self._noise_i = 0
        self._tab = hw._table()  # pricing table, bound once (hot path)
        self._dcost = self._tab._dc_fn  # specialized decode pricer
        self._tp = hw.tp

    def _noise(self) -> float:
        if self.noise_sigma <= 0:
            return self.slow_factor
        i = self._noise_i
        blk = self._noise_blk
        if i >= blk.shape[0]:
            blk = np.exp(self._rng.normal(0.0, self.noise_sigma,
                                          size=1024))
            self._noise_blk = blk
            i = 0
        self._noise_i = i + 1
        return self.slow_factor * float(blk[i])

    def prefill_iter(self, reqs: List[Request], n_tok: int, f: float
                     ) -> IterCost:
        self.n_iters += 1
        avg_ctx = n_tok / max(1, len(reqs))
        if self.batch_pricing:
            c = self.hw.prefill_iter_batch([n_tok], [avg_ctx], [f]).row(0)
            t = c.time_s * self._noise()
            return IterCost(t, c.power_w, c.power_w * t,
                            c.f_effective, c.theta)
        # flattened hw.prefill_iter — same operations, same order as the
        # layered path (see decode_iter), one noise draw either way
        noise = self._noise()
        tab = self._tab
        if n_tok <= 0:
            return IterCost(0.0, tab.p_idle * self._tp, 0.0, f, 0.0)
        time_s, p, _e, f_eff, theta = tab.cost(
            *tab.prefill_terms(n_tok, float(avg_ctx)), f)
        p *= self._tp
        t = time_s * noise
        return IterCost(t, p, p * t, f_eff, theta)

    def prefill_chunk(self, reqs: List[Request], takes: List[int],
                      n_new: int, n_ctx: int, f: float) -> IterCost:
        """Partial-prefill iteration: ``n_new`` fresh tokens against
        ``n_ctx`` resident prefix tokens (cache hits + earlier chunks)."""
        self.n_iters += 1
        if self.batch_pricing:
            c = self.hw.prefill_chunk_iter_batch(
                [n_new], [n_ctx], [max(1, len(reqs))], [f]
            ).row(0)
        else:
            c = self.hw.prefill_chunk_iter(n_new, n_ctx, max(1, len(reqs)), f)
        t = c.time_s * self._noise()
        return IterCost(t, c.power_w, c.power_w * t, c.f_effective, c.theta)

    def decode_iter(self, reqs: List[Request], n_req: int, n_kv: int,
                    f: float) -> IterCost:
        self.n_iters += 1
        if self.batch_pricing:
            c = self.hw.decode_iter_batch([n_req], [n_kv], [f]).row(0)
            t = c.time_s * self._noise()
            return IterCost(t, c.power_w, c.power_w * t,
                            c.f_effective, c.theta)
        # flattened hw.decode_iter: the dominant pricing call skips the
        # intermediate IterCost and prices straight off the table, with
        # the noise draw inlined (``_noise`` body, hoisted before the
        # zero-work branch — the pricer never touches the RNG, so the
        # draw sequence is unchanged) — bit-identical either way
        i = self._noise_i
        blk = self._noise_blk
        if i >= blk.shape[0]:
            blk = np.exp(self._rng.normal(0.0, self.noise_sigma,
                                          size=1024))
            self._noise_blk = blk
            i = 0
        self._noise_i = i + 1
        if n_req <= 0:
            return IterCost(0.0, self._tab.p_idle * self._tp, 0.0, f, 0.0)
        time_s, p, _e, f_eff, theta = self._dcost(n_req, n_kv, f)
        p *= self._tp
        t = time_s * (self.slow_factor * float(blk[i]))
        return IterCost(t, p, p * t, f_eff, theta)

    def spec_decode_iter(self, reqs: List[Request], n_req: int, n_kv: int,
                         k: int, accepts: List[int], draft_frac: float,
                         f: float) -> IterCost:
        """One speculative iteration: k+1 draft-model steps + a k-token
        verify forward.  ``accepts`` (the engine's acceptance
        realization) does not change this iteration's cost — drafting
        and verification run in full either way; acceptance decides the
        *yield* the engine books in finish_iteration."""
        self.n_iters += 1
        if self.batch_pricing:
            c = self.hw.spec_decode_iter_batch(
                [n_req], [n_kv], [k], draft_frac, [f]
            ).row(0)
        else:
            c = self.hw.spec_decode_iter(n_req, n_kv, k, draft_frac, f)
        t = c.time_s * self._noise()
        return IterCost(t, c.power_w, c.power_w * t, c.f_effective, c.theta)

    def hybrid_iter(self, dec_reqs: List[Request], n_req: int, n_kv: int,
                    pre_reqs: List[Request], takes: List[int],
                    n_new: int, n_ctx: int, f: float) -> IterCost:
        """Mixed iteration: decode step + piggybacked prefill chunk."""
        self.n_iters += 1
        if self.batch_pricing:
            c = self.hw.hybrid_iter_batch(
                [n_req], [n_kv], [n_new], [n_ctx],
                [max(1, len(pre_reqs))], [f]
            ).row(0)
        else:
            c = self.hw.hybrid_iter(
                n_req, n_kv, n_new, n_ctx, max(1, len(pre_reqs)), f
            )
        t = c.time_s * self._noise()
        return IterCost(t, c.power_w, c.power_w * t, c.f_effective, c.theta)

    # real-compute hooks (no-ops in pure simulation)
    def insert(self, req: Request) -> None:  # decode slot allocation
        pass

    def release(self, req: Request) -> None:  # decode slot free
        pass

    def prefix_inserted(self, req: Request, cache, now: float) -> None:
        """Called right after the engine inserted ``req``'s prompt into
        its radix cache: a paged real backend attaches the request's KV
        pool pages to the just-created nodes (zero-copy prefix reuse)
        and drops its own in-flight references."""

    def abort_prefill(self, reqs: List[Request]) -> None:
        """In-flight prefill work was lost (instance failure): a paged
        real backend releases the page references it stashed for it."""

    def flush(self) -> None:
        """Emit any deferred device-side tokens (end-of-run hook): the
        real backend's async dispatch materializes here; pure simulation
        has nothing in flight."""


# ---------------------------------------------------------------------------
# Drain / park lifecycle (EcoScale scale-in)
# ---------------------------------------------------------------------------


class ParkableEngine:
    """Shared drain→park→re-admit lifecycle for P/D engines.

    Draining stops new placements (routers skip non-``accepting``
    instances) while in-flight work runs to completion; once empty the
    instance parks and its energy integrates at the chip's sleep draw
    instead of idle draw until it is re-admitted.
    """

    def drain(self) -> None:
        self.accepting = False

    def _invalidate_controller(self) -> None:
        """Drop the controller's decision memo, if it keeps one.  Memo
        keys capture the full decision state, so this is about bounding
        staleness across lifecycle discontinuities (park/wake,
        preemption, failure) rather than correctness."""
        inv = getattr(getattr(self, "controller", None), "invalidate", None)
        if inv is not None:
            inv()

    def begin_park(self, now: float) -> None:
        if self._parked_at is None and self.empty:
            self._parked_at = now
            self._invalidate_controller()

    def unpark(self, now: float) -> None:
        if self._parked_at is not None:
            self.energy.parked_s += now - self._parked_at
            self._parked_at = None
            self._invalidate_controller()

    def readmit(self, now: float) -> None:
        self.accepting = True
        self.unpark(now)

    def close_park(self, end: float) -> None:
        """End-of-run bookkeeping: close an open park interval."""
        self.unpark(end)

    @property
    def parked(self) -> bool:
        return self._parked_at is not None


# ---------------------------------------------------------------------------
# Prefill instance
# ---------------------------------------------------------------------------


@dataclass
class PrefillEngine(ParkableEngine):
    idx: int
    backend: SimBackend
    controller: FreqController
    predictor: Optional[EcoPred]
    max_batch_tokens: int = 8_192
    record_trace: bool = False
    # chunked prefill: per-iteration *token* budget; None = legacy
    # whole-prompt FCFS batching (oversized prompts bypass the budget)
    chunk_tokens: Optional[int] = None
    # radix prefix cache; None = no prompt reuse
    cache: Optional[RadixCache] = None

    queue: TierQueue = field(default_factory=TierQueue)
    busy: bool = False
    busy_until: float = 0.0  # current batch's completion time
    alive: bool = True
    accepting: bool = True  # False while draining/parked (EcoScale)
    energy: InstanceEnergy = None  # set in __post_init__
    current_batch: List[Request] = field(default_factory=list)
    _takes: List[int] = field(default_factory=list)
    _locks: dict = field(default_factory=dict)  # rid -> radix lock handle
    _parked_at: Optional[float] = None

    def __post_init__(self):
        self.energy = InstanceEnergy(
            name=f"prefill-{self.idx}",
            idle_power_w=self.backend.hw.idle_power(),
            sleep_power_w=self.backend.hw.sleep_power(),
        )

    @property
    def empty(self) -> bool:
        return not self.queue and not self.current_batch

    @property
    def queued_tokens(self) -> int:
        """Prompt tokens still to *compute* across the queue (cache hits
        and already-prefilled chunks don't count as pending work)."""
        return sum(r.prefill_remaining for r in self.queue)

    def enqueue(self, req: Request, now: float = 0.0) -> None:
        req.phase = Phase.QUEUED_PREFILL
        req.prefill_instance = self.idx
        if self.cache is not None and req.prompt_tokens:
            req.cached_len = self.cache.lookup(req.prompt_tokens, now)
            self._locks[req.rid] = self.cache.lock(req.prompt_tokens)
        self.queue.append(req)

    def form_batch(self) -> Tuple[List[Request], int]:
        """Queue-order whole-prompt batching under the token budget
        (>=1 req); the queue itself is priority+EDF ordered (exact FCFS
        for untiered workloads).

        Legacy (unchunked) path: an oversized prompt is admitted whole,
        bypassing the budget — exactly the behavior chunked prefill fixes.
        """
        batch: List[Request] = []
        tokens = 0
        while self.queue:
            nxt = self.queue.peek()
            if batch and tokens + nxt.prefill_remaining > self.max_batch_tokens:
                break
            batch.append(self.queue.popleft())
            tokens += nxt.prefill_remaining
        return batch, tokens

    def form_chunk(self) -> Tuple[List[Request], List[int]]:
        """Queue-order *token-level* batching: fill the chunk budget
        exactly, splitting the boundary prompt across iterations.  Only
        the last admitted request can be partial, so batch order follows
        the queue (FCFS untiered; priority+EDF with tiers — an urgent
        arrival overtakes a half-prefilled batch prompt at the next chunk
        boundary)."""
        budget = self.chunk_tokens or self.max_batch_tokens
        batch: List[Request] = []
        takes: List[int] = []
        left = budget
        while self.queue and left > 0:
            nxt = self.queue.peek()
            take = min(nxt.prefill_remaining, left)
            if take <= 0:
                break
            batch.append(self.queue.popleft())
            takes.append(take)
            left -= take
        return batch, takes

    def start_iteration(self, now: float) -> Optional[Tuple[float, IterCost]]:
        """Begin one prefill iteration; returns (duration, cost) or None."""
        if not self.queue or not self.alive:
            self.busy = False
            return None
        if self.chunk_tokens is not None:
            batch, takes = self.form_chunk()
        else:
            batch, _ = self.form_batch()
            takes = [r.prefill_remaining for r in batch]
        n_new = sum(takes)
        n_ctx = sum(r.cached_len + r.computed_len for r in batch)
        self.current_batch = batch
        self._takes = takes
        for r in batch:
            r.phase = Phase.RUNNING_PREFILL
            if r.t_prefill_start < 0:
                r.t_prefill_start = now
        max_wait = max(now - r.arrival_s for r in batch)
        f = self.controller.select(
            SystemState(has_waiting=len(self.queue) > 0, now_s=now,
                        has_urgent_waiting=self.queue.has_urgent),
            BatchInfo("prefill", n_tok=n_new, max_waiting_s=max_wait,
                      n_cached=n_ctx,
                      budget_s=_batch_budget_s(batch, now)),
        )
        if self.chunk_tokens is not None or n_ctx > 0:
            cost = self.backend.prefill_chunk(batch, takes, n_new, n_ctx, f)
        else:
            # legacy whole-prompt path, bit-exact with pre-chunking costs
            cost = self.backend.prefill_iter(batch, n_new, f)
        self.busy = True
        self.busy_until = now + cost.time_s
        self.energy.busy_s += cost.time_s
        self.energy.busy_j += cost.energy_j
        if self.record_trace:
            self.energy.freq_trace.append((now, cost.f_effective, n_new))
        if self.predictor is not None:
            self.predictor.record_prefill(f, n_new, cost.time_s, n_ctx)
        return cost.time_s, cost

    def finish_iteration(self, now: float) -> List[Request]:
        """Iteration done: advance chunk progress; prompts that completed
        emit their first token and return (partial prompts re-queue,
        keeping their admission seq so they stay at the front of their
        tier class).  A preemption *resume* recomputes KV only — its
        first token was emitted long ago and keeps its timestamp."""
        batch, takes = self.current_batch, self._takes
        self.current_batch, self._takes = [], []
        done: List[Request] = []
        partial: List[Request] = []
        for r, take in zip(batch, takes):
            r.computed_len += take
            if r.prefill_remaining <= 0:
                if not r.resuming:
                    r.t_first_token = now
                r.resume_pending = False  # recompute (if any) is done
                r.phase = Phase.TRANSFERRING
                if self.cache is not None and r.prompt_tokens:
                    self.cache.unlock(self._locks.pop(r.rid, None))
                    self.cache.insert(r.prompt_tokens, now)
                    self.backend.prefix_inserted(r, self.cache, now)
                done.append(r)
            else:
                r.phase = Phase.QUEUED_PREFILL
                partial.append(r)
        self.queue.requeue(partial)
        return done

    def release_locks(self) -> None:
        """Drop cache pins of all in-flight work (failure path)."""
        if self.cache is None:
            return
        for handle in self._locks.values():
            self.cache.unlock(handle)
        self._locks.clear()


# ---------------------------------------------------------------------------
# Decode instance
# ---------------------------------------------------------------------------


@dataclass
class DecodeEngine(ParkableEngine):
    idx: int
    backend: SimBackend
    controller: FreqController
    predictor: Optional[EcoPred]
    max_running: int = 512
    kv_capacity_tokens: int = 2_000_000
    record_trace: bool = False
    # tier preemption: max evictions per request (0 = preemption off);
    # set by the cluster when SLO tiers are enabled
    preempt_cap: int = 0
    # paged KV accounting: footprints round up to whole pages, so
    # admission/headroom/cost all see the fragmentation a block-pool
    # allocator actually pays (0 = legacy token granularity, bit-exact)
    page_size: int = 0
    # speculative decoding: k > 0 turns every iteration into a
    # draft–verify pass that can emit up to k+1 tokens per request
    # (0 = legacy single-token decode, bit-exact).  The acceptance
    # *realization* is a control-plane decision drawn from spec_seed so
    # Sim and Real backends see identical yields (parity); the mechanics
    # (k+1-row verify forward, page-exact rollback) are the backend's.
    spec_k: int = 0
    spec_draft_frac: float = 0.05
    spec_accept_default: float = 0.7
    spec_seed: int = 0
    spec_ewma_alpha: float = 0.1

    waiting: TierQueue = field(default_factory=TierQueue)
    running: List[Request] = field(default_factory=list)
    busy: bool = False
    alive: bool = True
    accepting: bool = True  # False while draining/parked (EcoScale)
    energy: InstanceEnergy = None
    preempted_out: List[Request] = field(default_factory=list)
    _iter_cost: Optional[IterCost] = None
    _iter_f: float = 0.0
    _parked_at: Optional[float] = None
    # per-instance acceptance-rate EWMA (the controller/router signal)
    accept_ewma: float = 0.0
    _iter_accepts: List[int] = field(default_factory=list)
    _spec_rng: object = None

    def __post_init__(self):
        self.energy = InstanceEnergy(
            name=f"decode-{self.idx}",
            idle_power_w=self.backend.hw.idle_power(),
            sleep_power_w=self.backend.hw.sleep_power(),
        )
        self.accept_ewma = self.spec_accept_default
        self._spec_rng = np.random.default_rng(self.spec_seed)

    @property
    def empty(self) -> bool:
        return not self.running and not self.waiting

    # -- state-space coordinates (what the router sees) --------------------
    def _kv_footprint(self, n_tokens: int) -> int:
        """Resident KV footprint of an ``n_tokens``-long sequence: the
        tokens themselves, or — paged — their whole-page padding (a
        sequence owns its tail page even when half empty, and decode
        attention streams whole pages)."""
        if self.page_size <= 0 or n_tokens <= 0:
            return n_tokens
        ps = self.page_size
        return -(-n_tokens // ps) * ps

    @property
    def n_req(self) -> int:
        return len(self.running)

    @property
    def n_kv(self) -> int:
        # Hot path (read every iteration + every router probe): inline
        # the per-request footprint instead of a method call per request.
        ps = self.page_size
        if ps <= 0:
            return sum(r.kv_len for r in self.running)
        return sum(
            -(-r.kv_len // ps) * ps if r.kv_len > 0 else r.kv_len
            for r in self.running
        )

    @property
    def kv_headroom(self) -> int:
        """Startable KV capacity as the router/admission view it —
        net of the per-request speculative slack ``_fits`` reserves, so
        a speculating instance never advertises room it would refuse."""
        slack = (
            self._kv_footprint(self.spec_k + 1) if self.spec_k > 0 else 0
        )
        return (
            self.kv_capacity_tokens
            - self.n_kv - len(self.running) * slack
            - sum(
                self._kv_footprint(r.kv_len) + slack
                for r in self.waiting
            )
        )

    @property
    def binding_itl_s(self) -> Optional[float]:
        """Tightest resolved ITL target among resident requests (what a
        tier-aware router compares against); None when untiered/empty."""
        return _binding_itl_s(self.running)

    def enqueue(self, req: Request) -> None:
        req.phase = Phase.QUEUED_DECODE
        req.decode_instance = self.idx
        # a preemption resume re-enters with its recomputed context
        # (prompt + already-delivered tokens) resident
        req.kv_len = req.prompt_len + req.tokens_out
        self.waiting.append(req)

    def _fits(self, r: Request) -> bool:
        # speculative iterations transiently write k+1 tokens per request
        # before rollback: admission reserves that slack *page-granular*
        # (a resident whose tail page is full transiently allocates
        # whole fresh pages in _grow_for_verify — ceil((k+1)/page) of
        # them worst-case, which is exactly _kv_footprint(slack)).  The
        # incoming request's own slack is inside its padded footprint.
        slack = (self.spec_k + 1) if self.spec_k > 0 else 0
        return (
            len(self.running) < self.max_running
            and self.n_kv + self._kv_footprint(r.kv_len + slack)
            + len(self.running) * self._kv_footprint(slack)
            + len(self.running)
            <= self.kv_capacity_tokens
        )

    def _preempt_for(self, head: Request, now: float) -> bool:
        """KV/headroom pressure: evict one preemptible lower-priority
        running request (least urgent first: highest priority number,
        then latest deadline) so ``head`` can eventually admit.  The
        victim loses its KV and re-queues for prefill to *recompute*
        prompt + already-generated context; delivered tokens are never
        re-emitted.  Returns True if an eviction happened."""
        if self.preempt_cap <= 0:
            return False
        victims = [
            r for r in self.running
            if r.preemptible and r.priority > head.priority
            and r.preemptions < self.preempt_cap
        ]
        if not victims:
            return False
        v = max(victims, key=lambda r: (r.priority, r.deadline_s, r.rid))
        self.running.remove(v)
        self.backend.release(v)
        v.preemptions += 1
        v.preempt_gen_len = v.tokens_out
        v.resume_pending = True
        v.cached_len = v.computed_len = 0
        v.kv_len = 0
        v.phase = Phase.QUEUED_PREFILL
        # fresh TTFT-sized budget for the recompute (EDF key on resume)
        if v.slo_ttft_s > 0:
            v.deadline_s = now + v.slo_ttft_s
        self.preempted_out.append(v)
        self._invalidate_controller()
        return True

    def take_preempted(self) -> List[Request]:
        """Drain requests evicted since the last call (cluster re-routes
        them through prefill)."""
        out, self.preempted_out = self.preempted_out, []
        return out

    def _admit(self, now: float) -> None:
        while self.waiting:
            head = self.waiting.peek()
            if self._fits(head):
                r = self.waiting.popleft()
                r.phase = Phase.RUNNING_DECODE
                r.t_join_decode = now
                self.backend.insert(r)
                self.running.append(r)
                continue
            if not self._preempt_for(head, now):
                break

    # -- speculative decode: acceptance realization (control plane) --------
    def _accept_prob(self, r: Request) -> float:
        return (
            r.accept_rate if r.accept_rate >= 0.0
            else self.spec_accept_default
        )

    def _draw_accepts(self) -> Tuple[List[int], float]:
        """Per-request accepted-prefix lengths for this iteration.

        One Bernoulli(p) draw per draft slot, accepted prefix = leading
        successes — exactly ``k`` uniforms are consumed per request
        regardless of clipping, so the stream stays aligned between Sim
        and Real runs (backend-independent parity).  The *clipped* count
        (emitted = a+1 never exceeds the request's remaining tokens)
        drives KV growth.

        The EWMA signal is the truncated-geometric MLE of the per-token
        acceptance probability, ``Σa / Σ(a + 1{a<k})`` — each prefix of
        length ``a`` observed ``a`` successes and (unless the window was
        exhausted) one failure.  Feeding the raw accepted *fraction*
        ``E[a]/k`` instead would systematically understate ``p`` (and
        hence the per-emitted-token budget) wherever ``p`` is high,
        since ``expected_emitted`` expects a probability.  Pre-clip
        values are used so end-of-stream truncation does not read as
        acceptance collapse.
        """
        n, k = len(self.running), self.spec_k
        # one (n, k) draw consumes the identical bit stream in the
        # identical order as n sequential k-draws (C-order fill), so
        # the Sim==Real alignment contract is untouched while the
        # per-iteration Python overhead drops to O(1)
        u = self._spec_rng.random((n, k))
        p = np.fromiter(
            (self._accept_prob(r) for r in self.running), float, n
        )
        raw = (u < p[:, None]).astype(np.int64).cumprod(axis=1).sum(axis=1)
        succ = int(raw.sum())
        trials = succ + int((raw < k).sum())
        p_hat = succ / trials if trials else 1.0
        accepts = [
            min(int(a), max(0, r.remaining - 1))
            for a, r in zip(raw, self.running)
        ]
        return accepts, p_hat

    def start_iteration(self, now: float) -> Optional[Tuple[float, IterCost]]:
        if not self.alive:
            self.busy = False
            return None
        self._admit(now)
        if not self.running:
            self.busy = False
            return None
        n_req, n_kv = self.n_req, self.n_kv
        state = SystemState(has_waiting=len(self.waiting) > 0, now_s=now,
                            has_urgent_waiting=self.waiting.has_urgent)
        if self.spec_k > 0:
            accepts, p_hat = self._draw_accepts()
            self._iter_accepts = accepts
            a = self.spec_ewma_alpha
            self.accept_ewma = (1 - a) * self.accept_ewma + a * p_hat
            f = self.controller.select(
                state,
                BatchInfo(
                    "decode", n_req=n_req, n_kv=n_kv,
                    itl_slo_s=_binding_itl_s(self.running),
                    spec_k=self.spec_k,
                    emitted_per_iter=expected_emitted(
                        self.accept_ewma, self.spec_k
                    ),
                ),
            )
            cost = self.backend.spec_decode_iter(
                self.running, n_req, n_kv, self.spec_k, accepts,
                self.spec_draft_frac, f,
            )
        else:
            f = self.controller.select(
                state,
                BatchInfo("decode", n_req=n_req, n_kv=n_kv,
                          itl_slo_s=_binding_itl_s(self.running)),
            )
            cost = self.backend.decode_iter(self.running, n_req, n_kv, f)
        self._iter_cost, self._iter_f = cost, f
        self.busy = True
        self.energy.busy_s += cost.time_s
        self.energy.busy_j += cost.energy_j
        if self.record_trace:
            self.energy.freq_trace.append((now, cost.f_effective, n_req))
        if self.predictor is not None:
            if self.spec_k > 0:
                self.predictor.record_verify(
                    f, n_req, n_kv, self.spec_k, cost.time_s
                )
            else:
                self.predictor.record_decode(f, n_req, n_kv, cost.time_s)
        return cost.time_s, cost

    def predicted_iter_s(self, f: float) -> float:
        """Predicted duration of an iteration at the current state — the
        straggler-bias reference (verify model when speculating)."""
        if self.spec_k > 0:
            return self.predictor.predict_verify_scalar(
                f, self.n_req, self.n_kv, self.spec_k
            )
        return self.predictor.predict_decode_scalar(
            f, self.n_req, self.n_kv
        )

    def finish_iteration(self, now: float) -> List[Request]:
        """Book this iteration's yield; returns newly finished requests.

        Legacy decode emits exactly one token per running request.  A
        speculative iteration emits ``accepts[i] + 1`` tokens for request
        ``i`` (the accepted draft prefix plus the verify forward's
        bonus/correction token) — KV grows by the same amount, and the
        per-token ITL books as the iteration time split across the yield
        (all of an iteration's tokens arrive together, so the *per
        emitted token* latency is dt / yield).  Note the accounting
        choice: ``max_itl_s`` is the worst per-emitted-token latency,
        not the worst *burst gap* a streaming client would observe
        (that gap is the whole iteration's dt, by construction up to
        ITL × E[emitted] under the pacing budget); SLO attainment is
        judged on mean ITL (TPOT) for speculative and plain runs alike,
        so cross-arm comparisons stay apples-to-apples.
        """
        dt = self._iter_cost.time_s
        accepts = self._iter_accepts if self.spec_k > 0 else None
        self._iter_accepts = []
        done: List[Request] = []
        still: List[Request] = []
        for i, r in enumerate(self.running):
            m = 1 if accepts is None else accepts[i] + 1
            r.tokens_out += m
            r.kv_len += m
            r.max_itl_s = max(r.max_itl_s, dt / m)
            if accepts is not None:
                r.spec_iters += 1
                r.spec_drafted += self.spec_k
                r.spec_accepted += accepts[i]
            if r.tokens_out >= r.decode_len:
                r.t_finish = now
                r.phase = Phase.FINISHED
                self.backend.release(r)
                done.append(r)
            else:
                still.append(r)
        self.running = still
        return done

    # -- fault tolerance ----------------------------------------------------
    def fail(self) -> List[Request]:
        """Instance dies: KV is lost; in-flight requests need re-prefill."""
        self.alive = False
        self._invalidate_controller()
        lost = list(self.running) + list(self.waiting)
        self.running.clear()
        self.waiting.clear()
        for r in lost:
            r.restarts += 1
            r.tokens_out = 0
            r.kv_len = 0
            r.preempt_gen_len = 0  # everything re-generates from scratch
            r.resume_pending = False
            # stale ids must not survive into the regenerated stream (a
            # later preemption resume rebuilds context from this list)
            r.output_tokens = []
        return lost


# ---------------------------------------------------------------------------
# Hybrid instance (chunked prefill + decode coalesced, Sarathi-style)
# ---------------------------------------------------------------------------


@dataclass
class HybridEngine(DecodeEngine):
    """A decode instance that admits prefill *chunks* between decode steps.

    Each iteration is mixed: one decode token for every running request
    plus a prefill chunk of up to ``chunk_tokens`` new prompt tokens from
    the local prefill queue (the weight stream is shared — see
    :meth:`~repro.core.hwmodel.HardwareModel.hybrid_iter`).  Chunking
    bounds the decode stall a long prompt can inject to one chunk's
    latency instead of a whole prompt's, which is the point of admitting
    decode work between chunks.  A prompt prefilled here joins decode
    locally — no KV migration.
    """

    chunk_tokens: int = 2_048
    cache: Optional[RadixCache] = None
    pqueue: TierQueue = field(default_factory=TierQueue)
    p_current: List[Request] = field(default_factory=list)
    _p_takes: List[int] = field(default_factory=list)
    _locks: dict = field(default_factory=dict)  # rid -> radix lock handle

    def __post_init__(self):
        super().__post_init__()
        # idx may carry the cluster's hybrid view-offset; name by slot
        # (hybrids never speculate — spec_k stays 0: a piggybacked
        # chunk already owns the iteration's slack)
        self.energy.name = f"hybrid-{self.idx % (1 << 20)}"

    @property
    def empty(self) -> bool:
        return (not self.running and not self.waiting
                and not self.pqueue and not self.p_current)

    @property
    def queued_tokens(self) -> int:
        return sum(r.prefill_remaining for r in self.pqueue)

    def enqueue_prefill(self, req: Request, now: float = 0.0) -> None:
        req.phase = Phase.QUEUED_PREFILL
        req.prefill_instance = self.idx
        if self.cache is not None and req.prompt_tokens:
            req.cached_len = self.cache.lookup(req.prompt_tokens, now)
            self._locks[req.rid] = self.cache.lock(req.prompt_tokens)
        self.pqueue.append(req)

    def _form_chunk(self) -> Tuple[List[Request], List[int]]:
        batch: List[Request] = []
        takes: List[int] = []
        left = self.chunk_tokens
        while self.pqueue and left > 0:
            take = min(self.pqueue.peek().prefill_remaining, left)
            if take <= 0:
                break
            batch.append(self.pqueue.popleft())
            takes.append(take)
            left -= take
        return batch, takes

    def start_iteration(self, now: float) -> Optional[Tuple[float, IterCost]]:
        if not self.alive:
            self.busy = False
            return None
        self._admit(now)
        batch, takes = self._form_chunk()
        if not self.running and not batch:
            self.busy = False
            return None
        self.p_current, self._p_takes = batch, takes
        n_new = sum(takes)
        n_ctx = sum(r.cached_len + r.computed_len for r in batch)
        for r in batch:
            r.phase = Phase.RUNNING_PREFILL
            if r.t_prefill_start < 0:
                r.t_prefill_start = now
        # the clock must satisfy both phases' budgets: take the higher of
        # the two per-phase selections (higher f never misses harder)
        state = SystemState(
            has_waiting=bool(self.waiting) or bool(self.pqueue), now_s=now,
            has_urgent_waiting=(
                self.waiting.has_urgent or self.pqueue.has_urgent
            ),
        )
        f = 0.0
        if self.running:
            f = self.controller.select(
                state,
                BatchInfo("decode", n_req=self.n_req, n_kv=self.n_kv,
                          itl_slo_s=_binding_itl_s(self.running)),
            )
        if batch:
            max_wait = max(now - r.arrival_s for r in batch)
            f = max(f, self.controller.select(
                state,
                BatchInfo("prefill", n_tok=n_new, max_waiting_s=max_wait,
                          n_cached=n_ctx,
                          budget_s=_batch_budget_s(batch, now)),
            ))
        cost = self.backend.hybrid_iter(
            self.running, self.n_req, self.n_kv, batch, takes,
            n_new, n_ctx, f,
        )
        self._iter_cost, self._iter_f = cost, f
        self.busy = True
        self.energy.busy_s += cost.time_s
        self.energy.busy_j += cost.energy_j
        if self.record_trace:
            self.energy.freq_trace.append(
                (now, cost.f_effective, self.n_req + n_new)
            )
        if self.predictor is not None and self.running and not batch:
            # pure-decode iterations are on-distribution for the decode
            # model; mixed iterations are not recorded (their latency
            # includes the piggybacked chunk)
            self.predictor.record_decode(
                f, self.n_req, self.n_kv, cost.time_s
            )
        return cost.time_s, cost

    def finish_iteration(self, now: float) -> List[Request]:
        """Advance both phases; returns finished *decode* requests.
        Prompts completing prefill join this instance's decode queue
        directly (no P->D transfer)."""
        done = super().finish_iteration(now) if self.running else []
        batch, takes = self.p_current, self._p_takes
        self.p_current, self._p_takes = [], []
        partial: List[Request] = []
        for r, take in zip(batch, takes):
            r.computed_len += take
            if r.prefill_remaining <= 0:
                if not r.resuming:
                    r.t_first_token = now
                r.resume_pending = False  # recompute (if any) is done
                if self.cache is not None and r.prompt_tokens:
                    self.cache.unlock(self._locks.pop(r.rid, None))
                    self.cache.insert(r.prompt_tokens, now)
                    self.backend.prefix_inserted(r, self.cache, now)
                self.enqueue(r)  # local decode join, no migration
            else:
                r.phase = Phase.QUEUED_PREFILL
                partial.append(r)
        self.pqueue.requeue(partial)
        return done

    def fail(self) -> List[Request]:
        p_lost = list(self.p_current) + list(self.pqueue)
        self.backend.abort_prefill(p_lost)
        if self.cache is not None:
            for handle in self._locks.values():
                self.cache.unlock(handle)
            self._locks.clear()
        self.p_current.clear()
        self.pqueue.clear()
        for r in p_lost:
            r.restarts += 1
        return super().fail() + p_lost
