"""Workload generation: request arrival processes + length distributions.

Length distributions are lognormals moment-matched to the paper's Appx. D
Table I statistics (ShareGPT: prefill 280.3±375.6 / decode 190.9±209.2;
LMSYS: 78.4±133.3 / 174.6±166.1). Arrivals are Poisson at a controlled RPS
(§VI-A), with two structured generators on top:

* ``azure_like`` — the Fig. 2 diurnal two-class (conversation / code) mix:
  conversation prefill roughly flat, code peaking afternoon/evening with
  short decodes.
* ``synthetic_pd_ratio`` — the Appx. N trace whose prefill/decode demand
  ratio oscillates on a minutes scale (alternating long-prompt/short-output
  and short-prompt/long-output phases).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


# ---------------------------------------------------------------------------
# Length distributions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LengthDist:
    """Lognormal moment-matched to (mean, std), clipped to [lo, hi]."""

    mean: float
    std: float
    lo: int = 1
    hi: int = 32_768

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        sigma2 = math.log(1.0 + (self.std / self.mean) ** 2)
        mu = math.log(self.mean) - sigma2 / 2.0
        x = rng.lognormal(mu, math.sqrt(sigma2), n)
        return np.clip(np.round(x), self.lo, self.hi).astype(int)


@dataclass(frozen=True)
class DatasetDist:
    name: str
    prefill: LengthDist
    decode: LengthDist


# Paper Appx. D Table I
SHAREGPT = DatasetDist(
    "sharegpt",
    prefill=LengthDist(280.27, 375.58),
    decode=LengthDist(190.90, 209.15),
)
LMSYS = DatasetDist(
    "lmsys",
    prefill=LengthDist(78.40, 133.29),
    decode=LengthDist(174.57, 166.13),
)
# Azure-trace-like per-class distributions (conversation ~ sharegpt-ish;
# code: long prompts, short outputs — Fig. 2 discussion)
AZURE_CONV = DatasetDist(
    "azure-conv",
    prefill=LengthDist(1020.0, 1330.0),
    decode=LengthDist(211.0, 163.0),
)
AZURE_CODE = DatasetDist(
    "azure-code",
    prefill=LengthDist(2048.0, 1535.0),
    decode=LengthDist(28.0, 60.0),
)

# every DatasetDist registered under its own name — launch/serve.py and
# the benchmarks route --dataset through this one table (the azure
# classes used to be reachable only via the azure_like generator)
DATASETS = {
    d.name: d for d in (SHAREGPT, LMSYS, AZURE_CONV, AZURE_CODE)
}


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


def poisson_workload(
    dataset: DatasetDist,
    rps: float,
    duration_s: float,
    seed: int = 0,
    start_rid: int = 0,
) -> List[Request]:
    """Poisson arrivals at fixed RPS over ``duration_s`` (§VI-A)."""
    rng = np.random.default_rng(seed)
    n_est = int(rps * duration_s * 1.5) + 32
    gaps = rng.exponential(1.0 / rps, n_est)
    t = np.cumsum(gaps)
    t = t[t < duration_s]
    n = len(t)
    p = dataset.prefill.sample(rng, n)
    d = dataset.decode.sample(rng, n)
    return [
        Request(
            rid=start_rid + i,
            arrival_s=float(t[i]),
            prompt_len=int(p[i]),
            decode_len=int(d[i]),
            kind=dataset.name,
        )
        for i in range(n)
    ]


def azure_like(
    base_rps: float,
    duration_s: float,
    seed: int = 0,
    day_s: float = 86_400.0,
    t0_frac: float = 0.5,
) -> List[Request]:
    """Two-class diurnal mix (Fig. 2): conversation arrives ~flat; code RPS
    follows a half-sine peaking in the afternoon/evening."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    rid = 0
    # conversation: homogeneous Poisson
    reqs += poisson_workload(AZURE_CONV, base_rps, duration_s, seed)
    rid = len(reqs)
    # code: inhomogeneous Poisson via thinning
    lam_max = base_rps * 1.5
    t, n_est = 0.0, int(lam_max * duration_s * 1.5) + 32
    gaps = rng.exponential(1.0 / lam_max, n_est)
    times = np.cumsum(gaps)
    times = times[times < duration_s]
    keep = []
    for ti in times:
        frac = ((ti / day_s) + t0_frac) % 1.0
        lam = base_rps * 1.5 * max(0.0, math.sin(math.pi * frac)) ** 2
        if rng.random() < lam / lam_max:
            keep.append(ti)
    n = len(keep)
    p = AZURE_CODE.prefill.sample(rng, n)
    d = AZURE_CODE.decode.sample(rng, n)
    for i, ti in enumerate(keep):
        reqs.append(
            Request(rid + i, float(ti), int(p[i]), int(d[i]), kind="code")
        )
    reqs.sort(key=lambda r: r.arrival_s)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def synthetic_pd_ratio(
    rps: float,
    duration_s: float,
    period_s: float = 300.0,
    seed: int = 0,
) -> List[Request]:
    """Appx. N: P/D demand ratio oscillating with ``period_s``. Alternates
    prefill-heavy (long prompts, short outputs) and decode-heavy windows."""
    rng = np.random.default_rng(seed)
    heavy_p = DatasetDist(
        "pd-prefill-heavy",
        prefill=LengthDist(1600.0, 700.0),
        decode=LengthDist(48.0, 32.0),
    )
    heavy_d = DatasetDist(
        "pd-decode-heavy",
        prefill=LengthDist(96.0, 64.0),
        decode=LengthDist(420.0, 200.0),
    )
    gaps = rng.exponential(1.0 / rps, int(rps * duration_s * 1.5) + 32)
    times = np.cumsum(gaps)
    times = times[times < duration_s]
    reqs = []
    for i, ti in enumerate(times):
        window = int(ti / period_s) % 2
        ds = heavy_p if window == 0 else heavy_d
        reqs.append(
            Request(
                i, float(ti),
                int(ds.prefill.sample(rng, 1)[0]),
                int(ds.decode.sample(rng, 1)[0]),
                kind=ds.name,
            )
        )
    return reqs


def tiered_workload(
    base_rps: float,
    duration_s: float,
    seed: int = 0,
    interactive_frac: float = 0.45,
    standard_frac: float = 0.35,
    day_s: float = 86_400.0,
    t0_frac: float = 0.5,
) -> List[Request]:
    """Multi-tenant SLO-tier mix over the diurnal trace shape (Fig. 2).

    Three tenant classes share the cluster:

    * ``interactive`` — chat traffic (LMSYS-like lengths), flat Poisson
      at ``interactive_frac × base_rps``; the strictest TTFT/ITL tier.
    * ``standard``    — ShareGPT-like traffic, flat Poisson; mid tier.
    * ``batch``       — best-effort bulk work (code-gen-like: long
      prompts, short outputs) arriving as an inhomogeneous Poisson whose
      rate follows the Fig. 2 half-sine afternoon/evening peak at up to
      ``2 × (1 − interactive_frac − standard_frac) × base_rps``;
      preemptible + sheddable.

    Tier names resolve against ``ClusterConfig.slo_tiers`` at arrival;
    running the identical trace with ``slo_tiers=None`` is the
    single-tier max-attainment baseline (every request judged and paced
    at the strictest SLO).
    """
    # decorrelated stream for the batch class: reusing `seed` here would
    # replay the interactive stream's underlying exponentials, making
    # bulk arrival bursts a deterministic rescaling of interactive ones
    rng = np.random.default_rng(seed + 2)
    reqs: List[Request] = []
    reqs += _tag(
        poisson_workload(
            LMSYS, interactive_frac * base_rps, duration_s, seed
        ),
        "interactive",
    )
    reqs += _tag(
        poisson_workload(
            SHAREGPT, standard_frac * base_rps, duration_s, seed + 1
        ),
        "standard",
    )
    # batch: inhomogeneous Poisson via thinning (diurnal half-sine)
    batch_frac = max(0.0, 1.0 - interactive_frac - standard_frac)
    lam_max = 2.0 * batch_frac * base_rps
    if lam_max > 0.0:
        gaps = rng.exponential(
            1.0 / lam_max, int(lam_max * duration_s * 1.5) + 32
        )
        times = np.cumsum(gaps)
        times = times[times < duration_s]
        keep = []
        for ti in times:
            frac = ((ti / day_s) + t0_frac) % 1.0
            lam = lam_max * max(0.0, math.sin(math.pi * frac)) ** 2
            if rng.random() < lam / lam_max:
                keep.append(ti)
        p = AZURE_CODE.prefill.sample(rng, len(keep))
        d = AZURE_CODE.decode.sample(rng, len(keep))
        for i, ti in enumerate(keep):
            reqs.append(
                Request(
                    0, float(ti), int(p[i]), int(d[i]),
                    kind="bulk", tier="batch",
                )
            )
    reqs.sort(key=lambda r: r.arrival_s)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def _tag(reqs: List[Request], tier: str) -> List[Request]:
    for r in reqs:
        r.tier = tier
    return reqs


def step_load(
    dataset: DatasetDist,
    segments: List[tuple],
    seed: int = 0,
) -> List[Request]:
    """Piecewise-constant Poisson load: ``segments`` is a list of
    ``(duration_s, rps)`` windows played back-to-back.  The canonical
    autoscaler stimulus (trough → step up → trough)."""
    reqs: List[Request] = []
    t0 = 0.0
    for i, (dur, rps) in enumerate(segments):
        if rps > 0.0:
            seg = poisson_workload(
                dataset, rps, dur, seed=seed + 1_009 * i,
                start_rid=len(reqs),
            )
            for r in seg:
                r.arrival_s += t0
            reqs.extend(seg)
        t0 += dur
    return reqs


def multiturn_workload(
    n_conversations: int,
    duration_s: float,
    seed: int = 0,
    n_system_prompts: int = 4,
    system_len: LengthDist = LengthDist(1200.0, 400.0, lo=64, hi=4_096),
    user_len: LengthDist = LengthDist(120.0, 90.0, hi=2_048),
    decode: LengthDist = LengthDist(160.0, 120.0, hi=1_024),
    turns_mean: float = 6.0,
    think_mean_s: float = 6.0,
    vocab_size: int = 50_000,
    max_prompt: int = 16_384,
) -> List[Request]:
    """Multi-turn conversations with shared system prompts (azure-like
    agentic/chat traffic) — the prefix-cache stress workload.

    Every conversation belongs to one of ``n_system_prompts`` "apps" whose
    system prompt (a concrete token sequence) is shared across all of that
    app's conversations; each turn re-sends the conversation so far
    (system + alternating user/assistant history) plus a fresh user
    message.  The assistant tokens appended to the history are synthetic
    (the simulator's decode emits no ids) but *consistent*: turn ``k+1``'s
    prompt is a strict extension of turn ``k``'s prompt + its output
    length, so a radix cache sees exactly the reuse a real serving stack
    would.  Turn arrivals are spaced by exponential think time; turn
    counts are geometric with mean ``turns_mean``.
    """
    rng = np.random.default_rng(seed)
    systems = [
        rng.integers(0, vocab_size, size=int(n)).tolist()
        for n in system_len.sample(rng, n_system_prompts)
    ]
    reqs: List[Request] = []
    starts = np.sort(rng.uniform(0.0, duration_s, n_conversations))
    for conv_id, t0 in enumerate(starts):
        app = int(rng.integers(0, n_system_prompts))
        history = list(systems[app])
        n_turns = 1 + int(rng.geometric(1.0 / max(1.0, turns_mean)) - 1)
        t = float(t0)
        for turn in range(n_turns):
            u = int(user_len.sample(rng, 1)[0])
            history = history + rng.integers(0, vocab_size, size=u).tolist()
            if len(history) > max_prompt or t >= duration_s:
                break
            d = int(decode.sample(rng, 1)[0])
            reqs.append(
                Request(
                    rid=0,
                    arrival_s=t,
                    prompt_len=len(history),
                    decode_len=d,
                    kind=f"mt-app{app}",
                    conv_id=conv_id,
                    turn=turn,
                    prompt_tokens=list(history),
                )
            )
            # the next turn extends the history by this turn's output
            history = history + rng.integers(
                0, vocab_size, size=d + 1
            ).tolist()
            t += float(rng.exponential(think_mean_s))
    reqs.sort(key=lambda r: r.arrival_s)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def spec_heterogeneity_workload(
    base_rps: float,
    duration_s: float,
    seed: int = 0,
    templated_frac: float = 0.5,
    accept_templated: float = 0.88,
    accept_chat: float = 0.55,
    accept_jitter: float = 0.06,
) -> List[Request]:
    """Two-class mix whose *draft acceptance* differs — the speculative-
    decoding stress trace.

    * ``templated`` — code/boilerplate *generation* (moderate prompts,
      long structured outputs): drafts verify well,
      ``accept_rate ≈ accept_templated``.
    * ``chat``      — open-ended conversation (LMSYS lengths): drafts
      verify poorly, ``accept_rate ≈ accept_chat``.

    Per-request rates jitter around the class mean, so a decode
    instance's acceptance EWMA genuinely moves with its resident mix —
    which is exactly the state-space dimension acceptance-aware
    EcoRoute/EcoFreq exploit (and what ``fig_specdec`` measures).
    """
    templated_ds = DatasetDist(
        "templated",
        prefill=LengthDist(640.0, 320.0),
        decode=LengthDist(300.0, 140.0),
    )
    rng = np.random.default_rng(seed + 3)
    templated = _tag_accept(
        poisson_workload(
            templated_ds, templated_frac * base_rps, duration_s, seed
        ),
        "templated", accept_templated, accept_jitter, rng,
    )
    chat = _tag_accept(
        poisson_workload(
            LMSYS, (1.0 - templated_frac) * base_rps, duration_s, seed + 1
        ),
        "chat", accept_chat, accept_jitter, rng,
    )
    reqs = templated + chat
    reqs.sort(key=lambda r: r.arrival_s)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def _tag_accept(
    reqs: List[Request], kind: str, mean: float, jitter: float,
    rng: np.random.Generator,
) -> List[Request]:
    for r in reqs:
        r.kind = kind
        r.accept_rate = float(
            np.clip(rng.normal(mean, jitter), 0.05, 0.98)
        )
    return reqs


def attach_tokens(
    reqs: List[Request], vocab_size: int, seed: int = 0
) -> List[Request]:
    """Give each request concrete prompt token ids (RealEngine path)."""
    rng = np.random.default_rng(seed)
    for r in reqs:
        r.prompt_tokens = rng.integers(
            0, vocab_size, size=r.prompt_len
        ).tolist()
    return reqs
