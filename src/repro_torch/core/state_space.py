"""Decode state-space analysis utilities (paper Fig. 13).

The decode instance's state is ``(N_req, N_kv)``; EcoFreq + the ITL SLO
induce a frequency field over this plane whose discontinuities along
``N_req`` are the tile-quantization "cliffs". These helpers rasterize the
field (for the Fig. 13 benchmark and EcoRoute analysis) and locate the
cliff boundaries.

SLO tiers add a third coordinate: the *binding* ITL target of the
resident batch (``min_i slo_itl(r_i)``) — each tier mix induces its own
frequency field, and the energy value of tier-aware routing is exactly
the gap between these per-tier fields (``tier_frequency_fields``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ecofreq import (
    BatchInfo,
    EcoFreq,
    SystemState,
    expected_emitted,
)
from repro_torch.core.power import ChipSpec


def tile_boundaries(chip: ChipSpec, max_req: int) -> List[int]:
    """GEMM M-dim tile multiples in [1, max_req] (staircase cliffs)."""
    t = chip.mxu_tile
    return list(range(t, max_req + 1, t))


def frequency_field(
    ecofreq: EcoFreq,
    n_req_grid: Sequence[int],
    n_kv_grid: Sequence[int],
    itl_slo_s: Optional[float] = None,
) -> np.ndarray:
    """Chosen frequency at every (n_req, n_kv) grid point.

    ``itl_slo_s`` overrides the controller's global ITL target with a
    tier-binding one (None = the controller's own SLO, paper behavior).
    Returns (len(n_req_grid), len(n_kv_grid)) array of frequencies (MHz).
    """
    state = SystemState(has_waiting=False)
    out = np.empty((len(n_req_grid), len(n_kv_grid)))
    for i, q in enumerate(n_req_grid):
        for j, k in enumerate(n_kv_grid):
            out[i, j] = ecofreq.select(
                state,
                BatchInfo(phase="decode", n_req=int(q), n_kv=int(k),
                          itl_slo_s=itl_slo_s),
            )
    return out


def tier_frequency_fields(
    ecofreq: EcoFreq,
    tier_slo_itl_s: Dict[str, float],
    n_req_grid: Sequence[int],
    n_kv_grid: Sequence[int],
) -> Dict[str, np.ndarray]:
    """One frequency field per tier-binding ITL target.

    An instance whose residents are all of tier ``t`` operates on field
    ``fields[t]``; mixing a tighter tier in snaps it onto that tier's
    field — the energy gap between fields at the operating point is the
    cost of the mix (what :class:`~repro_torch.core.ecoroute.TierAwareEcoRoute`
    avoids paying).
    """
    return {
        name: frequency_field(ecofreq, n_req_grid, n_kv_grid, slo)
        for name, slo in tier_slo_itl_s.items()
    }


def spec_frequency_field(
    ecofreq: EcoFreq,
    n_req_grid: Sequence[int],
    n_kv_grid: Sequence[int],
    accept_grid: Sequence[float],
    spec_k: int,
    itl_slo_s: Optional[float] = None,
) -> np.ndarray:
    """Chosen frequency over the *speculative* decode state space
    ``(N_req, N_kv, acceptance)``.

    Speculative decoding adds the acceptance rate as a third coordinate:
    the per-emitted-token budget is ``ITL × E[emitted](p, k)``, so the
    same ``(N_req, N_kv)`` point maps to different frequencies as the
    batch's acceptance EWMA moves — high-acceptance instances can run
    colder clocks per joule-efficient emitted token, low-acceptance ones
    snap back toward the plain-decode field.  Returns
    ``(len(accept_grid), len(n_req_grid), len(n_kv_grid))``.
    """
    state = SystemState(has_waiting=False)
    out = np.empty((len(accept_grid), len(n_req_grid), len(n_kv_grid)))
    for a, p in enumerate(accept_grid):
        emit = expected_emitted(float(p), spec_k)
        for i, q in enumerate(n_req_grid):
            for j, k in enumerate(n_kv_grid):
                out[a, i, j] = ecofreq.select(
                    state,
                    BatchInfo(
                        phase="decode", n_req=int(q), n_kv=int(k),
                        itl_slo_s=itl_slo_s, spec_k=spec_k,
                        emitted_per_iter=emit,
                    ),
                )
    return out


def acceptance_cliffs(
    ecofreq: EcoFreq,
    n_req: int,
    n_kv: int,
    spec_k: int,
    n_grid: int = 101,
    itl_slo_s: Optional[float] = None,
) -> List[Tuple[float, float, float]]:
    """(acceptance, f_before, f_after) where the chosen frequency jumps
    as the acceptance EWMA sweeps 0 → 1 at a fixed ``(n_req, n_kv)`` —
    the acceptance-axis analogue of :func:`frequency_cliffs`."""
    state = SystemState(has_waiting=False)
    cliffs = []
    prev = None
    for p in np.linspace(0.0, 1.0, n_grid):
        f = ecofreq.select(
            state,
            BatchInfo(
                phase="decode", n_req=n_req, n_kv=n_kv,
                itl_slo_s=itl_slo_s, spec_k=spec_k,
                emitted_per_iter=expected_emitted(float(p), spec_k),
            ),
        )
        if prev is not None and f != prev:
            cliffs.append((float(p), prev, f))
        prev = f
    return cliffs


def frequency_cliffs(
    ecofreq: EcoFreq, n_kv: int, max_req: int,
    itl_slo_s: Optional[float] = None,
) -> List[Tuple[int, float, float]]:
    """(n_req, f_before, f_after) where the chosen frequency jumps as
    ``N_req`` crosses a boundary at fixed ``n_kv``."""
    state = SystemState(has_waiting=False)
    cliffs = []
    prev = None
    for q in range(1, max_req + 1):
        f = ecofreq.select(
            state,
            BatchInfo(phase="decode", n_req=q, n_kv=n_kv,
                      itl_slo_s=itl_slo_s),
        )
        if prev is not None and f != prev:
            cliffs.append((q, prev, f))
        prev = f
    return cliffs
