"""Trace replay: production arrival shapes behind the workload interface.

The hand-rolled Poisson mixes in ``workload.py`` control *rate*, but the
paper's headline dynamics are workload *shape* — the Fig. 2 diurnal
Azure trace, Appx. N's P/D-ratio oscillation, BurstGPT's burstiness.
This module makes shape a first-class, serializable object:

* :class:`Trace` — an ordered list of :class:`TraceRecord` (arrival
  time, prompt/decode token counts, plus workload identity: kind, SLO
  tier, conversation id/turn, draft-acceptance propensity).  Converts
  losslessly to/from ``Request`` lists (``trace_from_requests`` /
  ``Trace.to_requests``), so every existing generator composes into the
  trace world and any run's workload can be exported and replayed.
* **Ingestion** — ``load_azure_trace`` (AzurePublicDataset LLM
  inference schema: TIMESTAMP, ContextTokens, GeneratedTokens) and
  ``load_burstgpt_trace`` (BurstGPT schema: Timestamp, Model,
  Request/Response tokens), plus the canonical ``save`` / ``load_trace``
  round-trip format.  ``load_trace`` sniffs the header.
* **Rescaling** — ``rescale`` multiplies the arrival *rate* by warping
  the trace clock only: prompt/decode length marginals (and their joint)
  are preserved exactly.  ``resample`` draws a fresh Poisson arrival
  process whose (prompt, decode) pairs are bootstrapped from the source
  trace's empirical joint, for when a different duration/rate is needed
  — marginal *moments* match the source within sampling tolerance.
* **Synthesis** — segment dataclasses (:class:`DiurnalSegment`,
  :class:`FlashCrowdSegment`, :class:`TieredSegment`,
  :class:`AgenticSegment`) compose back-to-back via
  ``synthetic_trace``: diurnal cycles, flash crowds, multi-tenant tier
  mixes and agentic multi-turn phases in one parameterized trace.

Token identity: traces carry *shape*, not token ids.  ``to_requests``
can regenerate deterministic prompt ids; records of one conversation
(``conv_id >= 0``) draw from a shared per-conversation stream so each
turn's prompt strictly extends the previous turn's (the radix cache
sees within-conversation reuse).  Cross-conversation shared system
prompts are a token-level property the trace format does not encode —
use ``workload.multiturn_workload`` directly when that matters.
"""
from __future__ import annotations

import csv
import io
import math
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.serving.workload import (
    AZURE_CODE,
    DatasetDist,
    SHAREGPT,
    multiturn_workload,
    poisson_workload,
)


# ---------------------------------------------------------------------------
# Trace records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceRecord:
    """One arrival: trace-clock time + request shape + identity tags."""

    t_s: float
    prompt_tokens: int
    output_tokens: int  # total output tokens (= Request.decode_len + 1)
    kind: str = ""
    tier: str = ""
    conv_id: int = -1
    turn: int = 0
    accept_rate: float = -1.0  # draft-acceptance propensity; <0 = unknown


# canonical CSV column order (save/load round-trip format)
_COLUMNS = (
    "t_s", "prompt_tokens", "output_tokens", "kind", "tier",
    "conv_id", "turn", "accept_rate",
)


@dataclass
class Trace:
    """An arrival trace: records sorted by time, normalized to t0 = 0."""

    name: str
    records: List[TraceRecord]

    def __post_init__(self):
        if any(r.t_s < 0.0 for r in self.records):
            raise ValueError(
                f"trace '{self.name}': negative arrival time — normalize "
                "timestamps before constructing (loaders do this)"
            )
        if any(
            a.t_s > b.t_s
            for a, b in zip(self.records, self.records[1:])
        ):
            raise ValueError(
                f"trace '{self.name}': arrivals not sorted by t_s"
            )
        if any(
            r.prompt_tokens < 1 or r.output_tokens < 1
            for r in self.records
        ):
            raise ValueError(
                f"trace '{self.name}': prompt/output token counts must "
                "be >= 1"
            )

    def __len__(self) -> int:
        return len(self.records)

    # -- views --------------------------------------------------------------
    @property
    def arrivals_s(self) -> np.ndarray:
        return np.array([r.t_s for r in self.records])

    @property
    def prompt_lens(self) -> np.ndarray:
        return np.array([r.prompt_tokens for r in self.records])

    @property
    def output_lens(self) -> np.ndarray:
        return np.array([r.output_tokens for r in self.records])

    @property
    def duration_s(self) -> float:
        return float(self.records[-1].t_s) if self.records else 0.0

    @property
    def mean_rps(self) -> float:
        if len(self.records) < 2 or self.duration_s <= 0.0:
            return 0.0
        return (len(self.records) - 1) / self.duration_s

    def moments(self) -> Dict[str, float]:
        """Prompt/decode marginal moments (rescaling contract: these are
        preserved by ``rescale`` exactly and by ``resample`` within
        sampling tolerance)."""
        p, d = self.prompt_lens, self.output_lens
        return {
            "prompt_mean": float(p.mean()), "prompt_std": float(p.std()),
            "output_mean": float(d.mean()), "output_std": float(d.std()),
        }

    # -- conversion ---------------------------------------------------------
    def to_requests(
        self,
        tokens: bool = False,
        vocab_size: int = 50_000,
        seed: int = 0,
    ) -> List[Request]:
        """Materialize the trace as schedulable ``Request``s.

        ``tokens=True`` attaches deterministic prompt token ids:
        standalone records get independent streams keyed (seed, rid);
        conversation records (``conv_id >= 0``) share one stream per
        conversation, so successive turns are strict prefix extensions
        (prefix caches see genuine within-conversation reuse).
        """
        streams: Dict[int, np.ndarray] = {}
        reqs: List[Request] = []
        for i, r in enumerate(self.records):
            req = Request(
                rid=i,
                arrival_s=float(r.t_s),
                prompt_len=int(r.prompt_tokens),
                decode_len=max(1, int(r.output_tokens) - 1),
                kind=r.kind or "trace",
                tier=r.tier,
                conv_id=r.conv_id,
                turn=r.turn,
                accept_rate=r.accept_rate,
            )
            if tokens:
                key = r.conv_id if r.conv_id >= 0 else -(i + 1)
                buf = streams.get(key)
                if buf is None or len(buf) < req.prompt_len:
                    rng = np.random.default_rng(
                        np.random.SeedSequence([seed, key & 0xFFFFFFFF])
                    )
                    buf = rng.integers(
                        0, vocab_size,
                        size=max(req.prompt_len, 4_096),
                        dtype=np.int64,
                    )
                    streams[key] = buf
                req.prompt_tokens = buf[: req.prompt_len].tolist()
            reqs.append(req)
        return reqs

    # -- serialization ------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the canonical CSV (lossless: ``load_trace`` returns an
        equal trace; floats via repr round-trip exactly)."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(_COLUMNS)
            for r in self.records:
                w.writerow([
                    repr(float(r.t_s)), r.prompt_tokens, r.output_tokens,
                    r.kind, r.tier, r.conv_id, r.turn,
                    repr(float(r.accept_rate)),
                ])
        return path


def trace_from_requests(name: str, reqs: Sequence[Request]) -> Trace:
    """Capture any generator's output (or a served workload) as a trace."""
    recs = [
        TraceRecord(
            t_s=float(r.arrival_s),
            prompt_tokens=int(r.prompt_len),
            output_tokens=int(r.decode_len) + 1,
            kind=r.kind,
            tier=r.tier,
            conv_id=r.conv_id,
            turn=r.turn,
            accept_rate=float(r.accept_rate),
        )
        for r in sorted(reqs, key=lambda r: r.arrival_s)
    ]
    return Trace(name, recs)


# ---------------------------------------------------------------------------
# Ingestion
# ---------------------------------------------------------------------------


def _open(source: Union[str, io.TextIOBase]) -> io.TextIOBase:
    """Accept a path, an open file, or raw CSV text (embedded samples)."""
    if isinstance(source, io.TextIOBase):
        return source
    if isinstance(source, str) and "\n" in source:
        return io.StringIO(source)
    if isinstance(source, str) and os.path.exists(source):
        return open(source, newline="")
    raise FileNotFoundError(f"trace source not found: {source!r}")


def _normalize(name: str, rows: List[TraceRecord]) -> Trace:
    rows.sort(key=lambda r: r.t_s)
    if rows:
        t0 = rows[0].t_s
        rows = [replace(r, t_s=r.t_s - t0) for r in rows]
    return Trace(name, rows)


def load_canonical_trace(
    source: Union[str, io.TextIOBase], name: str = "trace"
) -> Trace:
    """Read the canonical format written by :meth:`Trace.save`."""
    out: List[TraceRecord] = []
    for row in csv.DictReader(_open(source)):
        out.append(TraceRecord(
            t_s=float(row["t_s"]),
            prompt_tokens=int(row["prompt_tokens"]),
            output_tokens=int(row["output_tokens"]),
            kind=row.get("kind", "") or "",
            tier=row.get("tier", "") or "",
            conv_id=int(row.get("conv_id", -1) or -1),
            turn=int(row.get("turn", 0) or 0),
            accept_rate=float(row.get("accept_rate", -1.0) or -1.0),
        ))
    # canonical files are already sorted/normalized; re-sorting here
    # would silently mask a corrupted export, so construct directly
    return Trace(name, out)


def load_azure_trace(
    source: Union[str, io.TextIOBase], name: str = "azure"
) -> Trace:
    """AzurePublicDataset LLM-inference schema.

    Columns (case-insensitive): ``TIMESTAMP`` (float seconds or ISO-8601
    datetime), ``ContextTokens``, ``GeneratedTokens``.  Arrivals are
    sorted and normalized to t0 = 0; zero-token rows are clamped to 1.
    """
    rows: List[TraceRecord] = []
    for row in csv.DictReader(_open(source)):
        low = {k.strip().lower(): v for k, v in row.items()}
        ts = low["timestamp"].strip()
        try:
            t = float(ts)
        except ValueError:  # ISO datetime
            from datetime import datetime

            t = datetime.fromisoformat(ts).timestamp()
        rows.append(TraceRecord(
            t_s=t,
            prompt_tokens=max(1, int(float(low["contexttokens"]))),
            output_tokens=max(1, int(float(low["generatedtokens"]))),
            kind=low.get("kind", "azure") or "azure",
        ))
    return _normalize(name, rows)


def load_burstgpt_trace(
    source: Union[str, io.TextIOBase], name: str = "burstgpt"
) -> Trace:
    """BurstGPT schema: ``Timestamp`` (seconds), ``Model``,
    ``Request tokens``, ``Response tokens`` (``Total tokens`` /
    ``Log Type`` ignored).  The model column becomes the record kind."""
    rows: List[TraceRecord] = []
    for row in csv.DictReader(_open(source)):
        low = {k.strip().lower(): v for k, v in row.items()}
        rows.append(TraceRecord(
            t_s=float(low["timestamp"]),
            prompt_tokens=max(1, int(float(low["request tokens"]))),
            output_tokens=max(1, int(float(low["response tokens"]))),
            kind=(low.get("model", "") or "burstgpt").strip(),
        ))
    return _normalize(name, rows)


def load_trace(
    source: Union[str, io.TextIOBase], name: Optional[str] = None
) -> Trace:
    """Sniff the header and dispatch to the matching schema loader."""
    f = _open(source)
    head = f.readline()
    f.seek(0)
    cols = {c.strip().lower() for c in head.split(",")}
    label = name or (
        os.path.splitext(os.path.basename(source))[0]
        if isinstance(source, str) and "\n" not in source else "trace"
    )
    if {"contexttokens", "generatedtokens"} <= cols:
        return load_azure_trace(f, label)
    if {"request tokens", "response tokens"} <= cols:
        return load_burstgpt_trace(f, label)
    if {"t_s", "prompt_tokens", "output_tokens"} <= cols:
        return load_canonical_trace(f, label)
    raise ValueError(
        f"unrecognized trace header {sorted(cols)} — expected the "
        "Azure LLM (ContextTokens/GeneratedTokens), BurstGPT "
        "(Request/Response tokens) or canonical (t_s/prompt_tokens/"
        "output_tokens) schema"
    )


# ---------------------------------------------------------------------------
# Rescaling
# ---------------------------------------------------------------------------


def rescale(trace: Trace, factor: float) -> Trace:
    """Scale the mean arrival rate by ``factor`` by warping the trace
    clock (t / factor).  Burst structure is preserved in relative time
    and the (prompt, output) joint distribution is untouched."""
    if factor <= 0.0:
        raise ValueError(f"rescale factor must be > 0, got {factor}")
    return Trace(
        f"{trace.name}@x{factor:g}",
        [replace(r, t_s=r.t_s / factor) for r in trace.records],
    )


def rescale_to_rps(trace: Trace, rps: float) -> Trace:
    """Warp the clock so the trace's mean RPS becomes ``rps``."""
    if trace.mean_rps <= 0.0:
        raise ValueError(
            f"trace '{trace.name}' has no measurable rate "
            f"({len(trace)} records)"
        )
    return rescale(trace, rps / trace.mean_rps)


def resample(
    trace: Trace, rps: float, duration_s: float, seed: int = 0
) -> Trace:
    """Fresh Poisson arrivals at ``rps`` over ``duration_s`` whose
    (prompt, output, kind, tier, accept) tuples are bootstrapped from
    the source trace — length marginal *moments* match the source
    within sampling error.  Conversation identity is dropped (records
    are drawn i.i.d., so turn chains would be incoherent)."""
    if not trace.records:
        raise ValueError(f"cannot resample empty trace '{trace.name}'")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rps, int(rps * duration_s * 1.5) + 32)
    times = np.cumsum(gaps)
    times = times[times < duration_s]
    picks = rng.integers(0, len(trace.records), size=len(times))
    recs = [
        replace(
            trace.records[j], t_s=float(t), conv_id=-1, turn=0,
        )
        for t, j in zip(times, picks)
    ]
    return Trace(f"{trace.name}~{rps:g}rps", recs)


def tile(trace: Trace, n: int) -> Trace:
    """Repeat the trace ``n`` times back-to-back on one clock — burst
    structure is preserved within each cycle; cycles are separated by
    the trace's mean inter-arrival gap (so the long-run rate matches
    the source).  Conversation ids are re-keyed per cycle."""
    if n < 1:
        raise ValueError(f"tile count must be >= 1, got {n}")
    if not trace.records:
        return Trace(trace.name, [])
    gap = (
        1.0 / trace.mean_rps if trace.mean_rps > 0.0 else 1.0
    )
    period = trace.duration_s + gap
    convs = sorted({r.conv_id for r in trace.records if r.conv_id >= 0})
    recs: List[TraceRecord] = []
    for c in range(n):
        for r in trace.records:
            conv = r.conv_id
            if conv >= 0:
                conv = conv + c * (max(convs) + 1)
            recs.append(replace(r, t_s=r.t_s + c * period, conv_id=conv))
    return Trace(f"{trace.name}x{n}", recs)


# ---------------------------------------------------------------------------
# Synthetic trace segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiurnalSegment:
    """One diurnal cycle (Fig. 2 shape): rate follows base + (peak-base)
    * sin²(π·t/duration), via inhomogeneous-Poisson thinning."""

    duration_s: float
    base_rps: float
    peak_rps: float
    dataset: DatasetDist = SHAREGPT
    tier: str = ""

    def generate(self, seed: int) -> List[Request]:
        rng = np.random.default_rng(seed)
        lam_max = max(self.base_rps, self.peak_rps)
        if lam_max <= 0.0:
            return []
        gaps = rng.exponential(
            1.0 / lam_max, int(lam_max * self.duration_s * 1.5) + 32
        )
        times = np.cumsum(gaps)
        times = times[times < self.duration_s]
        keep = []
        for t in times:
            lam = self.base_rps + (self.peak_rps - self.base_rps) * (
                math.sin(math.pi * t / self.duration_s) ** 2
            )
            if rng.random() < lam / lam_max:
                keep.append(float(t))
        p = self.dataset.prefill.sample(rng, len(keep))
        d = self.dataset.decode.sample(rng, len(keep))
        return [
            Request(i, t, int(p[i]), int(d[i]),
                    kind=self.dataset.name, tier=self.tier)
            for i, t in enumerate(keep)
        ]


@dataclass(frozen=True)
class FlashCrowdSegment:
    """Steady base load with a flash crowd: arrivals spike to
    ``spike_x × base_rps`` inside [spike_start_s, spike_start_s +
    spike_len_s) — the attainment-vs-burst stress shape."""

    duration_s: float
    base_rps: float
    spike_x: float = 6.0
    spike_start_s: float = 0.0
    spike_len_s: float = 10.0
    dataset: DatasetDist = SHAREGPT
    spike_dataset: Optional[DatasetDist] = None
    tier: str = ""

    def generate(self, seed: int) -> List[Request]:
        base = poisson_workload(
            self.dataset, self.base_rps, self.duration_s, seed=seed
        )
        extra_rps = (self.spike_x - 1.0) * self.base_rps
        reqs = list(base)
        if extra_rps > 0.0 and self.spike_len_s > 0.0:
            ds = self.spike_dataset or self.dataset
            spike = poisson_workload(
                ds, extra_rps, self.spike_len_s, seed=seed + 1,
            )
            for r in spike:
                r.arrival_s += self.spike_start_s
                r.kind = f"{ds.name}-flash"
            reqs += spike
        for r in reqs:
            r.tier = self.tier or r.tier
        return reqs


@dataclass(frozen=True)
class TieredSegment:
    """Multi-tenant tier mix: per-tier (fraction, dataset) classes share
    one Poisson rate — the SLO-tier scheduling stress shape."""

    duration_s: float
    rps: float
    mix: Tuple[Tuple[str, float, DatasetDist], ...] = (
        ("interactive", 0.45, SHAREGPT),
        ("standard", 0.35, SHAREGPT),
        ("batch", 0.20, AZURE_CODE),
    )

    def generate(self, seed: int) -> List[Request]:
        reqs: List[Request] = []
        for i, (tier, frac, ds) in enumerate(self.mix):
            if frac <= 0.0:
                continue
            part = poisson_workload(
                ds, frac * self.rps, self.duration_s, seed=seed + i
            )
            for r in part:
                r.tier = tier
            reqs += part
        return reqs


@dataclass(frozen=True)
class AgenticSegment:
    """Agentic multi-turn conversations (prefix-extending turns with
    think-time gaps) — the prefix-cache/affinity stress shape."""

    duration_s: float
    n_conversations: int
    turns_mean: float = 5.0
    think_mean_s: float = 4.0
    tier: str = ""

    def generate(self, seed: int) -> List[Request]:
        reqs = multiturn_workload(
            self.n_conversations, self.duration_s, seed=seed,
            turns_mean=self.turns_mean, think_mean_s=self.think_mean_s,
        )
        for r in reqs:
            r.tier = self.tier or r.tier
        return reqs


Segment = Union[
    DiurnalSegment, FlashCrowdSegment, TieredSegment, AgenticSegment
]


def synthetic_trace(
    segments: Sequence[Segment], seed: int = 0, name: str = "synthetic"
) -> Trace:
    """Compose segments back-to-back on one trace clock.  Each segment
    draws from its own decorrelated stream; conversation ids are
    re-keyed per segment so agentic phases never collide."""
    reqs: List[Request] = []
    t0 = 0.0
    conv_off = 0
    for i, seg in enumerate(segments):
        sseed = int(np.random.SeedSequence([seed, i]).generate_state(
            1, np.uint64
        )[0] & 0x7FFFFFFF)
        part = seg.generate(sseed)
        max_conv = -1
        for r in part:
            r.arrival_s += t0
            if r.conv_id >= 0:
                max_conv = max(max_conv, r.conv_id)
                r.conv_id += conv_off
        conv_off += max_conv + 1
        reqs += part
        t0 += seg.duration_s
    return trace_from_requests(name, reqs)


# ---------------------------------------------------------------------------
# Embedded format samples (ingestion fixtures; also the burstgpt-replay
# scenario's seed trace — rescaled/resampled up by the registry)
# ---------------------------------------------------------------------------


def _sample_csv(schema: str, n: int = 64, seed: int = 1234) -> str:
    """Deterministic sample text in a foreign schema (built once at
    import; stands in for a checked-in trace excerpt without shipping a
    data file)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.7, n))
    # BurstGPT-like burstiness: compress every 4th inter-arrival run
    t = np.sort(t * (1.0 - 0.6 * (np.arange(n) % 4 == 0)))
    p = np.clip(rng.lognormal(5.6, 1.0, n), 8, 8_000).astype(int)
    d = np.clip(rng.lognormal(4.9, 0.8, n), 4, 1_500).astype(int)
    out = io.StringIO()
    w = csv.writer(out)
    if schema == "azure":
        w.writerow(["TIMESTAMP", "ContextTokens", "GeneratedTokens"])
        for i in range(n):
            w.writerow([f"{t[i]:.3f}", p[i], d[i]])
    else:
        w.writerow(["Timestamp", "Model", "Request tokens",
                    "Response tokens", "Total tokens", "Log Type"])
        for i in range(n):
            model = "ChatGPT" if i % 3 else "GPT-4"
            w.writerow([f"{t[i]:.3f}", model, p[i], d[i],
                        p[i] + d[i], "Conversation log"])
    return out.getvalue()


AZURE_SAMPLE_CSV = _sample_csv("azure")
BURSTGPT_SAMPLE_CSV = _sample_csv("burstgpt")
