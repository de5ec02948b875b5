"""EcoRoute — state-space guided decode routing (paper §V-E, Alg. 2).

Each decode instance's operating condition is a point in the
``(N_req, N_kv)`` state space; EcoFreq maps that point (plus the ITL SLO)
to a frequency, and MXU/GEMM tile boundaries carve the space into
frequency regions with "cliffs" (Fig. 13). Routing a request moves an
instance through this space, so EcoRoute runs a *what-if* pass:

    F  = freq(m_i)        current frequency of each instance
    F' = freq(m_i ⊕ r)    frequency after hypothetically adding request r

* **Case ①** — some-but-not-all instances would raise frequency AND
  ``max(F') − min(F') ≤ Δ``: pick the instance with the lowest *unchanged*
  frequency (don't push anyone over a cliff).
* **Case ②** — otherwise (no change / all raise / spread > Δ): round-robin
  among the instances with the lowest *resulting* frequency ``min(F')``.

The what-if EcoPred queries for all candidates batch into one call.
Round-robin and a recency-spread prefill router live here as baselines.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.ecofreq import (
    BatchInfo,
    EcoFreq,
    SystemState,
    expected_emitted,
)

if TYPE_CHECKING:  # identity-only imports (avoid heavy deps at runtime)
    from repro_torch.core.hwmodel import HardwareModel
    from repro_torch.core.power import ChipSpec


def _view_emitted(v: "InstanceView") -> float:
    """Expected tokens per iteration at the instance's current
    acceptance EWMA (1.0 when speculation is off)."""
    if v.spec_k <= 0:
        return 1.0
    return expected_emitted(
        v.accept_ewma if v.accept_ewma is not None else 0.0, v.spec_k
    )


def _hyp_emitted(v: "InstanceView", req: "RouteRequest") -> float:
    """Expected tokens per iteration *after* hypothetically placing
    ``req``: the request's own acceptance propensity shifts the
    instance's mean — this is the acceptance axis of the what-if (a
    low-acceptance request landing on a high-acceptance instance dilutes
    everyone's yield and the router prices exactly that)."""
    if v.spec_k <= 0:
        return 1.0
    p = v.accept_ewma if v.accept_ewma is not None else 0.0
    if req.accept_rate is not None:
        p = (p * v.n_req + req.accept_rate) / (v.n_req + 1)
    return expected_emitted(p, v.spec_k)


@dataclass(slots=True)
class InstanceView:
    """Router-visible state of one decode instance (m_i)."""

    idx: int
    n_req: int
    n_kv: int
    has_waiting: bool = False
    alive: bool = True
    accepting: bool = True  # False while draining/parked (EcoScale)
    kv_headroom: int = 1 << 62  # tokens of KV space left
    latency_bias_s: float = 0.0  # straggler signal from EcoPred residuals
    busy_remaining_s: float = 0.0  # in-flight batch time left (prefill)
    cached_len: int = 0  # radix-cache prefix match for the request (prefill)
    # SLO-tier coordinate: the binding (minimum) resolved ITL target of
    # the instance's resident requests — None when empty or untiered
    binding_itl_s: Optional[float] = None
    # speculative-decode coordinates: the instance's draft window and its
    # per-instance acceptance-rate EWMA — together they set the expected
    # tokens emitted per iteration, which is what converts an iteration's
    # joules into J per *emitted* token.  (0, None) = speculation off.
    spec_k: int = 0
    accept_ewma: Optional[float] = None


@dataclass(slots=True)
class RouteRequest:
    """What the router knows about the request being placed."""

    prompt_len: int  # tokens entering the instance's KV cache
    # resolved ITL target of the request's SLO tier (None = untiered:
    # cluster-default SLOs)
    itl_slo_s: Optional[float] = None
    # the request's own draft-acceptance propensity (None = unknown:
    # the instance EWMA stands unshifted in the what-if)
    accept_rate: Optional[float] = None


class Router(Protocol):
    def route(self, views: List[InstanceView], req: RouteRequest) -> int: ...


def _candidates(
    views: List[InstanceView], req: RouteRequest
) -> List[InstanceView]:
    """Placeable instances, best pool first: accepting with KV headroom,
    then *any* alive instance with headroom (a draining instance with
    space beats queueing on a KV-full one), then accepting, then alive —
    routing never fails while any instance is alive."""
    accepting = [v for v in views if v.alive and v.accepting]
    cands = [v for v in accepting if v.kv_headroom >= req.prompt_len]
    if not cands:
        alive = [v for v in views if v.alive]
        cands = (
            [v for v in alive if v.kv_headroom >= req.prompt_len]
            or accepting
            or alive
        )
    assert cands, "no alive instances"
    return cands


# ---------------------------------------------------------------------------
# Round-robin (SGLang default; prefill router everywhere)
# ---------------------------------------------------------------------------


class RoundRobinRouter:
    def __init__(self):
        self._rr = itertools.count()

    def route(self, views: List[InstanceView], req: RouteRequest) -> int:
        cands = _candidates(views, req)
        return cands[next(self._rr) % len(cands)].idx


# ---------------------------------------------------------------------------
# EcoRoute (Alg. 2)
# ---------------------------------------------------------------------------


_ROUTE_MEMO_CAP = 4096  # distinct quantized route states kept per router


class EcoRoute:
    def __init__(self, ecofreq: EcoFreq, delta: float, memo: bool = True):
        """``delta`` is the imbalance-prevention threshold Δ (MHz).
        ``memo=False`` disables the decision memo (always re-evaluate)."""
        self.ecofreq = ecofreq
        self.delta = delta
        self._rr = 0
        self.memo = memo
        self._memo: dict = {}
        self._memo_version = -1
        self.route_memo_hits = 0
        self.route_memo_misses = 0
        self.route_batch_queries = 0
        self.route_batch_rows = 0

    def invalidate(self) -> None:
        """Drop memoized decisions (behavior-neutral: keys are exact)."""
        self._memo.clear()

    # -- frequency decision for a hypothetical decode state ---------------
    def _freqs(
        self,
        states: np.ndarray,
        bias: Optional[np.ndarray] = None,
        spec_k: Optional[np.ndarray] = None,
        emit: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """states: (n, 2) of (n_req, n_kv) -> chosen frequency per row.

        Vectorized Alg. 1 step-3 (no waiting queue in the what-if): for
        every (instance, frequency-option) pair predict T_D and take the
        lowest option meeting the ITL SLO. ``bias`` adds a per-row latency
        offset (straggler signal from EcoPred residuals).  Rows with
        ``spec_k > 0`` query the verify model instead and compare against
        a budget scaled by ``emit`` (expected tokens per iteration) — the
        per-emitted-token pacing mirror of EcoFreq's step 3.
        """
        opts = np.asarray(self.ecofreq.freq_options)
        n = states.shape[0]
        pred = self.ecofreq.predictor
        self.route_batch_queries += 1
        self.route_batch_rows += n
        if spec_k is not None and (spec_k > 0).any():
            spec_rows = np.flatnonzero(spec_k > 0)
            plain_rows = np.flatnonzero(spec_k <= 0)
            t = np.empty((n, len(opts)))
            if plain_rows.size:  # each model queried only for its own rows
                t[plain_rows] = pred.predict_decode_matrix(
                    opts, states[plain_rows, 0], states[plain_rows, 1]
                )
            if spec_rows.size:
                t[spec_rows] = pred.predict_verify_matrix(
                    opts, states[spec_rows, 0], states[spec_rows, 1],
                    spec_k[spec_rows].astype(float),
                )
        else:
            # one (n_states × n_ladder) matrix, one model call
            t = pred.predict_decode_matrix(opts, states[:, 0], states[:, 1])
        if bias is not None:
            t = t + bias[:, None]
        slo = self.ecofreq.slo_itl_s
        if emit is not None:
            slo = slo * np.maximum(emit, 1.0)[:, None]
        ok = t <= slo
        # first qualifying option; none -> max
        first = np.where(ok.any(axis=1), ok.argmax(axis=1), len(opts) - 1)
        return opts[first]

    def _route_key(self, states, bias, spec, emit):
        """Quantized key under which the (f_cur, f_hyp) arrays are
        constant: the predictor's bin coordinates of every row (GBTree
        output is constant within a cell) plus the exact bias/spec/emit
        bytes.  None when the predictor isn't bin-keyable."""
        pred = self.ecofreq.predictor
        try:
            e = pred.decode_model.bin_edges_
            qb = np.searchsorted(e[1], states[:, 0], side="right")
            kb = np.searchsorted(e[2], states[:, 1], side="right")
        except (AttributeError, TypeError):
            return None
        key = (qb.tobytes(), kb.tobytes(), bias.tobytes())
        if emit is not None:
            vm = pred.verify_model
            if vm is None or vm.bin_edges_ is None:
                return None
            ev = vm.bin_edges_
            qv = np.searchsorted(ev[1], states[:, 0], side="right")
            kv = np.searchsorted(ev[2], states[:, 1], side="right")
            sv = np.searchsorted(ev[3], spec.astype(float), side="right")
            key += (qv.tobytes(), kv.tobytes(), sv.tobytes(),
                    spec.tobytes(), emit.tobytes())
        return key

    def route(self, views: List[InstanceView], req: RouteRequest) -> int:
        cands = _candidates(views, req)
        cur = np.array([[v.n_req, v.n_kv] for v in cands], float)
        hyp = cur + np.array([[1.0, float(req.prompt_len)]])
        bias = np.array([v.latency_bias_s for v in cands] * 2)
        spec = np.array([v.spec_k for v in cands] * 2, int)
        emit = None
        if (spec > 0).any():
            emit = np.array(
                [_view_emitted(v) for v in cands]
                + [_hyp_emitted(v, req) for v in cands]
            )
        states = np.concatenate([cur, hyp], axis=0)
        # one batched EcoPred pass for current + hypothetical states,
        # memoized on the quantized route state (selection below always
        # re-runs so the live round-robin counter keeps advancing)
        both = key = None
        if self.memo:
            pv = getattr(self.ecofreq.predictor, "version", 0)
            if pv != self._memo_version:
                self._memo.clear()
                self._memo_version = pv
            key = self._route_key(states, bias, spec, emit)
            if key is not None:
                both = self._memo.get(key)
        if both is None:
            both = self._freqs(states, bias, spec, emit)
            if key is not None:
                self.route_memo_misses += 1
                if len(self._memo) >= _ROUTE_MEMO_CAP:
                    self._memo.clear()
                self._memo[key] = both
        else:
            self.route_memo_hits += 1
        f_cur, f_hyp = both[: len(cands)], both[len(cands):]

        raised = f_hyp > f_cur
        spread = float(f_hyp.max() - f_hyp.min())
        if raised.any() and not raised.all() and spread <= self.delta:
            # case ① — lowest *unchanged* frequency
            unchanged = np.flatnonzero(~raised)
            j = unchanged[np.argmin(f_cur[unchanged])]
            return cands[int(j)].idx
        # case ② — round-robin among argmin resulting frequency
        lo = np.flatnonzero(f_hyp == f_hyp.min())
        j = lo[self._rr % len(lo)]
        self._rr += 1
        return cands[int(j)].idx


# ---------------------------------------------------------------------------
# EcoScale: phase- and chip-aware placement for heterogeneous fleets
# ---------------------------------------------------------------------------


@dataclass
class InstanceProfile:
    """Chip identity of one instance for heterogeneous what-if routing.

    ``ecofreq`` carries the instance's own frequency ladder and its chip's
    EcoPred; ``hw`` is the chip's latency/energy model used to price the
    marginal joules of a placement.
    """

    chip: "ChipSpec"
    ecofreq: EcoFreq
    hw: "HardwareModel"


class EnergyAwareEcoRoute:
    """EcoRoute generalized to heterogeneous fleets (EcoScale placement).

    The homogeneous Alg. 2 compares frequencies across instances, which is
    only meaningful when every instance shares one ladder.  Here each
    candidate's what-if runs on *its own* ladder and predictor, and
    candidates are scored in physical units instead:

    * ``t_hyp`` — predicted ITL after hypothetically adding the request,
      at the lowest SLO-meeting frequency of that instance's ladder;
    * ``dE``   — marginal energy per decode iteration,
      ``E_iter(state ⊕ r, f') − E_iter(state, f)``.  One iteration emits
      one token for this request on *any* chip, so dE is directly the
      marginal J/token of placing the request there — frequency cliffs
      show up as a dE spike exactly like Alg. 2's case ①.

    Selection: among SLO-meeting candidates, round-robin within ``tol`` of
    the lowest marginal energy; if none meets the SLO, lowest ``t_hyp``.
    """

    def __init__(
        self,
        profiles: Dict[int, InstanceProfile],
        slo_itl_s: float,
        tol: float = 0.05,
        spec_draft_frac: float = 0.05,
        memo: bool = True,
    ):
        self.profiles = profiles
        self.slo_itl_s = slo_itl_s
        self.tol = tol
        self.spec_draft_frac = spec_draft_frac
        self._rr = 0
        # marginal energy is continuous in the raw state (hw model, not
        # the binned predictor), so this memo keys on the *exact* state
        # tuple — low hit rate under churn, but always correct
        self.memo = memo
        self._memo: dict = {}
        self._memo_version = -1
        self.route_memo_hits = 0
        self.route_memo_misses = 0
        self.route_batch_queries = 0
        self.route_batch_rows = 0

    def _pred_version(self) -> int:
        return sum(
            getattr(p.ecofreq.predictor, "version", 0)
            for p in self.profiles.values()
        )

    def invalidate(self) -> None:
        """Drop memoized decisions (behavior-neutral: keys are exact)."""
        self._memo.clear()

    def _whatif(
        self, p: InstanceProfile, n_req: int, n_kv: int, bias: float,
        slo_s: Optional[float] = None, spec_k: int = 0, emit: float = 1.0,
    ) -> tuple:
        """Lowest SLO-meeting (f, predicted ITL) on p's own ladder.
        Speculative instances query the verify model and pace against
        the per-emitted-token budget ``slo × E[emitted]``."""
        slo = self.slo_itl_s if slo_s is None else slo_s
        slo = slo * max(1.0, emit)
        opts = np.asarray(p.ecofreq.freq_options)
        if spec_k > 0:
            t = p.ecofreq.predictor.predict_verify(
                opts, np.full(len(opts), float(n_req)),
                np.full(len(opts), float(n_kv)),
                np.full(len(opts), float(spec_k)),
            ) + bias
        else:
            t = p.ecofreq.predictor.predict_decode(
                opts, np.full(len(opts), float(n_req)),
                np.full(len(opts), float(n_kv)),
            ) + bias
        ok = t <= slo
        j = int(ok.argmax()) if ok.any() else len(opts) - 1
        return float(opts[j]), float(t[j])

    def _whatifs(self, rows: list) -> list:
        """Batched :meth:`_whatif`: ``rows`` is a list of
        ``(profile, n_req, n_kv, bias, slo_scaled, spec_k)`` queries.
        Queries sharing a (predictor, ladder) — the whole fleet, when
        homogeneous — collapse into one matrix call per model family.
        Returns ``[(f, t), ...]`` bit-identical to the scalar loop."""
        out: list = [None] * len(rows)
        groups: Dict[tuple, List[int]] = {}
        for i, (p, _q, _c, _b, _s, sk) in enumerate(rows):
            gk = (id(p.ecofreq.predictor), p.ecofreq.freq_options, sk > 0)
            groups.setdefault(gk, []).append(i)
        for (_pid, _opts, is_spec), idxs in groups.items():
            p0 = rows[idxs[0]][0]
            opts = np.asarray(p0.ecofreq.freq_options)
            q = np.array([rows[i][1] for i in idxs], float)
            c = np.array([rows[i][2] for i in idxs], float)
            self.route_batch_queries += 1
            self.route_batch_rows += len(idxs)
            if is_spec:
                k = np.array([rows[i][5] for i in idxs], float)
                t = p0.ecofreq.predictor.predict_verify_matrix(
                    opts, q, c, k
                )
            else:
                t = p0.ecofreq.predictor.predict_decode_matrix(opts, q, c)
            for j, i in enumerate(idxs):
                ti = t[j] + rows[i][3]
                ok = ti <= rows[i][4]
                jj = int(ok.argmax()) if ok.any() else len(opts) - 1
                out[i] = (float(opts[jj]), float(ti[jj]))
        return out

    def _iter_energy(
        self, p: InstanceProfile, n_req: int, n_kv: int, f: float,
        spec_k: int,
    ) -> float:
        if spec_k > 0:
            return p.hw.spec_decode_iter(
                n_req, n_kv, spec_k, self.spec_draft_frac, f
            ).energy_j
        return p.hw.decode_iter(n_req, n_kv, f).energy_j

    def _slos(
        self, v: InstanceView, req: RouteRequest
    ) -> tuple:
        """(current binding ITL, binding after placing req) — one global
        SLO here; the tier-aware subclass substitutes per-tier bindings."""
        return self.slo_itl_s, self.slo_itl_s

    def _score(self, cands: List[InstanceView], req: RouteRequest) -> list:
        """Per-candidate ``(meets_slo, dE, t_hyp)`` triples — the
        view-independent part of :meth:`route` (what the memo caches).
        What-ifs for every candidate's current + hypothetical states
        batch into grouped matrix calls."""
        rows: list = []
        meta: list = []
        for v in cands:
            p = self.profiles[v.idx]
            cur_slo, hyp_slo = self._slos(v, req)
            # acceptance axis of the what-if: expected yield before and
            # after the placement (1.0 when speculation is off), so
            # candidates compete on J per *emitted* token, not per
            # iteration — the tokens-per-joule pricing
            em_cur = _view_emitted(v)
            em_hyp = _hyp_emitted(v, req)
            hyp_i = len(rows)
            rows.append((p, v.n_req + 1, v.n_kv + req.prompt_len,
                         v.latency_bias_s, hyp_slo * max(1.0, em_hyp),
                         v.spec_k))
            cur_i = None
            if v.n_req > 0:
                cur_i = len(rows)
                rows.append((p, v.n_req, v.n_kv, v.latency_bias_s,
                             cur_slo * max(1.0, em_cur), v.spec_k))
            meta.append((v, p, hyp_i, cur_i, hyp_slo, em_cur, em_hyp))
        fts = self._whatifs(rows)
        scored = []
        for v, p, hyp_i, cur_i, hyp_slo, em_cur, em_hyp in meta:
            f_hyp, t_hyp = fts[hyp_i]
            e_hyp = self._iter_energy(
                p, v.n_req + 1, v.n_kv + req.prompt_len, f_hyp, v.spec_k
            ) / em_hyp
            e_cur = 0.0
            if cur_i is not None:
                f_cur, _ = fts[cur_i]
                e_cur = self._iter_energy(
                    p, v.n_req, v.n_kv, f_cur, v.spec_k
                ) / em_cur
            scored.append(
                (t_hyp <= hyp_slo * max(1.0, em_hyp), e_hyp - e_cur, t_hyp)
            )
        return scored

    def route(self, views: List[InstanceView], req: RouteRequest) -> int:
        cands = _candidates(views, req)
        scored = key = None
        if self.memo:
            pv = self._pred_version()
            if pv != self._memo_version:
                self._memo.clear()
                self._memo_version = pv
            key = (
                (req.prompt_len, req.itl_slo_s, req.accept_rate),
                tuple(
                    (v.idx, v.n_req, v.n_kv, v.latency_bias_s,
                     v.binding_itl_s, v.spec_k, v.accept_ewma)
                    for v in cands
                ),
            )
            scored = self._memo.get(key)
        if scored is None:
            scored = self._score(cands, req)
            if key is not None:
                self.route_memo_misses += 1
                if len(self._memo) >= _ROUTE_MEMO_CAP:
                    self._memo.clear()
                self._memo[key] = scored
        else:
            self.route_memo_hits += 1
        pick = _select(
            [s + (v,) for s, v in zip(scored, cands)], self._rr, self.tol
        )
        self._rr += 1
        return pick.idx


class TierAwareEcoRoute(EnergyAwareEcoRoute):
    """State-space routing over tiered traffic (EcoRoute generalized to
    per-instance binding SLOs).

    With SLO tiers the decode state space gains a third coordinate: the
    *binding* ITL target of the residents, ``min_i slo_itl(r_i)`` — the
    deadline EcoFreq actually paces the whole instance against.  Placing
    a request tightens that binding to ``min(binding, slo(r))``, so the
    what-if prices exactly the cross-tier coupling Alg. 2 cannot see:

    * an **interactive** request landing on an instance saturated with
      batch work forces the *entire* resident batch up to the strict
      clock — a huge marginal energy ``dE`` — so interactive traffic
      naturally avoids batch-saturated instances;
    * a **batch** request joining a strict (interactive-bound) instance
      pays that instance's high clock for every future token, while on a
      lax instance it decodes at the bottom of the ladder — so batch
      work self-segregates onto lax instances.

    Scoring is :class:`EnergyAwareEcoRoute`'s physical-units rule
    (inherited) with the per-candidate binding SLO substituted via
    :meth:`_slos`: among candidates whose hypothetical ITL meets the
    *new* binding target, round-robin within ``tol`` of the lowest
    marginal energy; otherwise lowest latency.  ``slo_itl_s`` is the
    fallback for untiered requests/views.
    """

    def _slos(self, v: InstanceView, req: RouteRequest) -> tuple:
        req_slo = req.itl_slo_s if req.itl_slo_s else self.slo_itl_s
        if v.n_req == 0:
            # empty instance: the request alone defines the binding —
            # falling back to the strict base SLO here would misprice
            # lax-tier placements and defeat batch self-segregation
            return req_slo, req_slo
        cur_slo = v.binding_itl_s if v.binding_itl_s else self.slo_itl_s
        return cur_slo, min(cur_slo, req_slo)


def _select(scored, rr: int, tol: float):
    """Round-robin among candidates within ``tol`` of the best score:
    marginal energy for SLO-meeting candidates, projected latency
    otherwise.  The tie band is additive around the minimum so negative
    marginal energies (tile-boundary effects) stay well-defined."""
    ok = [s for s in scored if s[0]]
    pool, col = (ok, 1) if ok else (scored, 2)
    best = min(s[col] for s in pool)
    band = abs(best) * tol + 1e-9
    tied = [s for s in pool if s[col] <= best + band]
    return tied[rr % len(tied)][3]


class EnergyAwarePrefillRouter:
    """Chip-aware prefill placement for heterogeneous fleets.

    Views carry (queue depth, queued tokens) in ``(n_req, n_kv)``.  Per
    candidate: project the queue-drain TTFT of ``queued + prompt`` tokens
    on that chip's ladder, and price the prompt's own prefill joules at
    the frequency the what-if picks.  Budget-meeting candidates compete
    on marginal energy; otherwise on projected latency.

    ``budget_frac`` discounts the TTFT SLO for the gate: the queue-drain
    projection cannot see the in-flight batch or arrival bursts, so the
    cheap chip only keeps winning while its projected drain stays well
    inside the budget — past that, load spills to the next chip instead
    of piling onto the efficient one until it actually misses.
    """

    def __init__(
        self,
        profiles: Dict[int, InstanceProfile],
        slo_ttft_s: float,
        tol: float = 0.05,
        budget_frac: float = 0.5,
        memo: bool = True,
    ):
        self.profiles = profiles
        self.slo_ttft_s = slo_ttft_s
        self.tol = tol
        self.budget = slo_ttft_s * budget_frac
        self._rr = 0
        self.memo = memo
        self._memo: dict = {}
        self._memo_version = -1
        self.route_memo_hits = 0
        self.route_memo_misses = 0
        self.route_batch_queries = 0
        self.route_batch_rows = 0

    def _whatif(self, p: InstanceProfile, n_tok: int) -> tuple:
        opts = np.asarray(p.ecofreq.freq_options)
        t = p.ecofreq.predictor.predict_prefill(
            opts, np.full(len(opts), float(n_tok))
        )
        ok = t <= self.budget
        j = int(ok.argmax()) if ok.any() else len(opts) - 1
        return float(opts[j]), float(t[j])

    def _whatifs(self, cands: List[InstanceView], n_toks: list,
                 n_cached: Optional[list] = None) -> list:
        """Batched queue-drain what-ifs: candidates sharing a
        (predictor, ladder) collapse into one prefill matrix call."""
        out: list = [None] * len(cands)
        groups: Dict[tuple, List[int]] = {}
        for i, v in enumerate(cands):
            p = self.profiles[v.idx]
            gk = (id(p.ecofreq.predictor), p.ecofreq.freq_options)
            groups.setdefault(gk, []).append(i)
        for idxs in groups.values():
            p0 = self.profiles[cands[idxs[0]].idx]
            opts = np.asarray(p0.ecofreq.freq_options)
            toks = np.array([n_toks[i] for i in idxs], float)
            cached = (
                np.array([n_cached[i] for i in idxs], float)
                if n_cached is not None else 0
            )
            self.route_batch_queries += 1
            self.route_batch_rows += len(idxs)
            t = p0.ecofreq.predictor.predict_prefill_matrix(
                opts, toks, cached
            )
            for j, i in enumerate(idxs):
                ok = t[j] <= self.budget
                jj = int(ok.argmax()) if ok.any() else len(opts) - 1
                out[i] = (float(opts[jj]), float(t[j][jj]))
        return out

    def _pred_version(self) -> int:
        return sum(
            getattr(p.ecofreq.predictor, "version", 0)
            for p in self.profiles.values()
        )

    def _memo_lookup(self, key):
        pv = self._pred_version()
        if pv != self._memo_version:
            self._memo.clear()
            self._memo_version = pv
        return self._memo.get(key)

    def _memo_store(self, key, scored) -> None:
        self.route_memo_misses += 1
        if len(self._memo) >= _ROUTE_MEMO_CAP:
            self._memo.clear()
        self._memo[key] = scored

    def invalidate(self) -> None:
        """Drop memoized decisions (behavior-neutral: keys are exact)."""
        self._memo.clear()

    def _score(self, cands: List[InstanceView], req: RouteRequest) -> list:
        fts = self._whatifs(
            cands, [v.n_kv + req.prompt_len for v in cands]
        )
        scored = []
        for v, (f_hyp, t_hyp) in zip(cands, fts):
            t_hyp += v.busy_remaining_s  # head-of-line: in-flight batch
            e_marg = self.profiles[v.idx].hw.prefill_iter(
                req.prompt_len, req.prompt_len, f_hyp
            ).energy_j
            scored.append((t_hyp <= self.budget, e_marg, t_hyp))
        return scored

    def route(self, views: List[InstanceView], req: RouteRequest) -> int:
        cands = _candidates(views, req)
        scored = key = None
        if self.memo:
            key = (
                req.prompt_len,
                tuple((v.idx, v.n_kv, v.busy_remaining_s) for v in cands),
            )
            scored = self._memo_lookup(key)
        if scored is None:
            scored = self._score(cands, req)
            if key is not None:
                self._memo_store(key, scored)
        else:
            self.route_memo_hits += 1
        pick = _select(
            [s + (v,) for s, v in zip(scored, cands)], self._rr, self.tol
        )
        self._rr += 1
        return pick.idx


class CacheAffinityPrefillRouter(EnergyAwarePrefillRouter):
    """Prefix-cache-aware prefill placement (hit-rate-weighted what-if).

    Each candidate view carries ``cached_len`` — the longest prefix of the
    arriving prompt resident in that instance's radix tree.  Placement
    runs the same queue-drain what-if as
    :class:`EnergyAwarePrefillRouter`, but on the *effective* new tokens
    ``prompt_len − cached_len``, and prices the marginal joules with the
    partial-prefill cost model (a hit skips both compute and energy).

    Selection among candidates whose projected TTFT meets the discounted
    budget: longest prefix match first (cache affinity keeps a
    conversation's turns landing where its tree lives), tie-broken by
    predicted marginal energy.  If nobody meets the budget, lowest
    projected latency wins — affinity never beats an SLO miss.  Falling
    back through ``tol``-banded round-robin keeps cold prompts spread.
    """

    def _whatif(self, p: InstanceProfile, n_new: int, n_cached: int) -> tuple:
        """Lowest budget-meeting (f, projected drain) on p's ladder for a
        queue of ``n_new`` fresh tokens over ``n_cached`` resident ones."""
        opts = np.asarray(p.ecofreq.freq_options)
        t = p.ecofreq.predictor.predict_prefill(
            opts, np.full(len(opts), float(n_new)),
            np.full(len(opts), float(n_cached)),
        )
        ok = t <= self.budget
        j = int(ok.argmax()) if ok.any() else len(opts) - 1
        return float(opts[j]), float(t[j])

    def _score(self, cands: List[InstanceView], req: RouteRequest) -> list:
        n_news = [max(1, req.prompt_len - v.cached_len) for v in cands]
        fts = self._whatifs(
            cands,
            # v.n_kv carries the instance's queued (pending) tokens
            [v.n_kv + n for v, n in zip(cands, n_news)],
            [v.cached_len for v in cands],
        )
        scored = []
        for v, n_new, (f_hyp, t_hyp) in zip(cands, n_news, fts):
            t_hyp += v.busy_remaining_s  # head-of-line: in-flight batch
            e_marg = self.profiles[v.idx].hw.prefill_chunk_iter(
                n_new, v.cached_len, 1, f_hyp
            ).energy_j
            scored.append((t_hyp <= self.budget, v.cached_len, e_marg,
                           t_hyp))
        return scored

    def route(self, views: List[InstanceView], req: RouteRequest) -> int:
        cands = _candidates(views, req)
        cached = key = None
        if self.memo:
            key = (
                req.prompt_len,
                tuple((v.idx, v.n_kv, v.busy_remaining_s, v.cached_len)
                      for v in cands),
            )
            cached = self._memo_lookup(key)
        if cached is None:
            cached = self._score(cands, req)
            if key is not None:
                self._memo_store(key, cached)
        else:
            self.route_memo_hits += 1
        scored = [s + (v,) for s, v in zip(cached, cands)]
        ok = [s for s in scored if s[0]]
        if ok:
            best_match = max(s[1] for s in ok)
            if best_match > 0:
                # cache affinity: longest prefix wins; ties on energy
                tied = [s for s in ok if s[1] == best_match]
                return min(tied, key=lambda s: s[2])[4].idx
            pool, col = ok, 2  # all cold: compete on marginal energy
        else:
            pool, col = scored, 3  # nobody meets budget: fastest drain
        best = min(s[col] for s in pool)
        band = abs(best) * self.tol + 1e-9
        tied = [s for s in pool if s[col] <= best + band]
        pick = tied[self._rr % len(tied)][4]
        self._rr += 1
        return pick.idx


# ---------------------------------------------------------------------------
# Failure-aware wrapper (fleet substrate, DESIGN.md §7)
# ---------------------------------------------------------------------------


class FaultTolerantRouter:
    """Drops dead instances from the candidate set; if the chosen instance
    died between heartbeat and dispatch, falls back to any alive one."""

    def __init__(self, inner: Router):
        self.inner = inner

    def route(self, views: List[InstanceView], req: RouteRequest) -> int:
        alive = [v for v in views if v.alive]
        assert alive, "cluster has no alive instances"
        idx = self.inner.route(alive, req)
        if not next(v for v in views if v.idx == idx).alive:
            idx = alive[0].idx
        return idx
