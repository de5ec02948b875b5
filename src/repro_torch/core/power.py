"""Chip power/energy model — the physical substrate of the paper's Eqs. 1-3.

The paper fits ``P ~ A + B f^{1+alpha}`` and ``T ~ f^{-beta}`` and observes a
U-shaped energy-frequency curve with a sweet spot (1005 MHz on A100 for both
phases; 1095/1395 MHz for prefill/decode on GH200).  Rather than painting
those curves in by hand, this module models the two physical mechanisms that
produce them, so every paper phenomenon *emerges*:

* **Voltage floor** — below ``f_volt_knee`` the DVFS table is at V_min, so
  down-clocking stops saving dynamic energy per op while static energy grows
  with the longer runtime  =>  energy strictly increases below the knee
  ("frequencies below 1005 MHz are strictly suboptimal", paper Fig. 5).
  Above the knee, voltage rises steeply (``V ~ 1 + volt_slope * (x-x_knee)``),
  so P_dyn ~ f V^2 grows super-linearly  =>  energy rises toward f_max.
  Together: the U shape, with the minimum pinned at the knee.
* **Clock-domain coupling** — only a fraction ``mu`` of memory time is truly
  DRAM-bound (frequency-independent); the rest (L2/NoC/issue) scales with the
  core clock.  This reconciles the roofline compute share (~0.3 for decode)
  with the paper's measured frequency sensitivity (~0.62 f-scalable share,
  i.e. 1005->1410 MHz gives only ~20 % ITL reduction, Fig. 5b).
* **Memory knee** — the memory path loses efficiency below ``f_mem_knee``
  (``g(x) = (x_mem_knee/x)^gamma``).  On the A100 both knees coincide
  (1005 MHz); on the GH200 the memory knee sits higher (1395 MHz), which is
  why decode's sweet spot lands at 1395 while prefill's lands at 1095
  (paper Appx. M) — a mechanistic account of the phase-specific sweet spots.
* **TDP wall** — if the requested operating point would draw more than
  ``tdp`` watts, the clock is throttled to the frequency where P == tdp
  (prefill hits this near 1305 MHz on A100, Fig. 5a).

Calibration anchors (A100, from the paper):
  decode:  f 1005->1410 MHz  =>  ITL x0.8, energy x1.5      (Fig. 5b bottom)
  prefill: near-proportional TTFT gain, TDP wall ~1305 MHz  (Fig. 5a)
  sweet spots: 1005 MHz both phases (A100); 1095/1395 (GH200)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence, Tuple

# ---------------------------------------------------------------------------
# Chip specification
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChipSpec:
    name: str
    # compute / memory roofline at f_max
    peak_flops: float  # bf16 FLOP/s
    hbm_bw: float  # bytes/s
    hbm_bytes: float
    gemm_eff: float  # achievable fraction of peak for large GEMMs
    mem_eff: float  # achievable fraction of HBM bandwidth
    # DVFS
    f_max: float  # MHz
    f_min: float  # MHz
    f_volt_knee: float  # MHz — voltage floor; prefill sweet spot
    f_mem_knee: float  # MHz — memory-path knee; decode sweet spot
    volt_slope: float  # V(f_max)/V(f_knee) - 1
    mem_knee_gamma: float  # DRAM-efficiency loss exponent below mem knee
    mu_dram: float  # fraction of memory time that is truly f-independent
    # power
    p_idle: float  # W — static + board
    p_elec_max: float  # W — unconstrained electrical draw at f_max, util=1
    tdp: float  # W — enforced cap (clock throttle)
    # power-utilization mapping u(theta): u = clip(u_k0 + u_k1 * theta)
    u_k0: float
    u_k1: float
    # architectural granularity
    mxu_tile: int  # GEMM M-dim tile => "staircase" period
    # interconnect (for the TPU roofline)
    ici_bw: float = 0.0  # bytes/s per link
    ici_links: int = 0
    # parked draw (W): drained instance, clocks floored, HBM in
    # self-refresh — what an EcoScale-parked instance costs per second
    p_sleep: float = 0.0
    # paper-style frequency option lists (MHz)
    freq_levels_2: Tuple[float, ...] = ()
    freq_levels_5: Tuple[float, ...] = ()

    def x(self, f: float) -> float:
        """Normalized frequency f/f_max."""
        return f / self.f_max

    @property
    def x_volt_knee(self) -> float:
        return self.f_volt_knee / self.f_max

    @property
    def x_mem_knee(self) -> float:
        return self.f_mem_knee / self.f_max

    def freq_grid(self, n: int = 40) -> Sequence[float]:
        lo, hi = self.f_min, self.f_max
        return [lo + (hi - lo) * i / (n - 1) for i in range(n)]


# ---------------------------------------------------------------------------
# Voltage / power / throttle
# ---------------------------------------------------------------------------


def voltage(chip: ChipSpec, f: float) -> float:
    """Relative core voltage V(f)/V_min (voltage floor below the knee)."""
    x = chip.x(f)
    xk = chip.x_volt_knee
    if x <= xk:
        return 1.0
    return 1.0 + chip.volt_slope * (x - xk) / (1.0 - xk)


def power_util(chip: ChipSpec, theta_scalable: float) -> float:
    """Map the workload's frequency-scalable time share -> power utilization.

    ``theta_scalable`` is the fraction of iteration time that scales with the
    core clock (compute + core-coupled memory).  Calibrated so prefill
    (theta~0.97) draws ~TDP and steady decode (theta~0.62) draws the
    paper-consistent decode power.
    """
    u = chip.u_k0 + chip.u_k1 * theta_scalable
    return min(1.0, max(0.05, u))


def power(chip: ChipSpec, f: float, util: float) -> float:
    """Electrical power draw (W) at frequency f and power-utilization util.

    P = P_idle + (P_elec_max - P_idle) * util * x * V(x)^2 / V(1)^2
    (the paper's Eq. 1 with an explicit DVFS voltage curve).
    """
    x = chip.x(f)
    v = voltage(chip, f)
    v1 = voltage(chip, chip.f_max)
    dyn = (chip.p_elec_max - chip.p_idle) * util * x * (v * v) / (v1 * v1)
    return chip.p_idle + dyn


def throttled_frequency(chip: ChipSpec, f: float, util: float) -> float:
    """Effective frequency after the TDP wall (clock throttling).

    If P(f, util) exceeds TDP, the chip runs at the highest f' with
    P(f', util) <= TDP.  Solved by bisection (P is monotone in f).
    """
    if power(chip, f, util) <= chip.tdp:
        return f
    lo, hi = chip.f_min, f
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if power(chip, mid, util) <= chip.tdp:
            lo = mid
        else:
            hi = mid
    return lo


def mem_slowdown(chip: ChipSpec, f: float) -> float:
    """DRAM-path slowdown factor g(x) >= 1 below the memory knee."""
    x = chip.x(f)
    xk = chip.x_mem_knee
    if x >= xk:
        return 1.0
    return (xk / x) ** chip.mem_knee_gamma


def energy(p_watts: float, t_seconds: float) -> float:
    """E = P * T (Joules) — the paper's objective."""
    return p_watts * t_seconds


# ---------------------------------------------------------------------------
# Chip registry — calibration documented per chip
# ---------------------------------------------------------------------------

# A100-80G SXM4.  Anchors: sweet spot 1005 MHz (both phases); decode
# 1005->1410 gives ITL x0.8 / energy x1.5; prefill TDP wall ~1305 MHz.
# Derivation (DESIGN.md §2): theta_decode = 0.62 requires mu_dram = 0.56;
# energy x1.5 with p_idle 60 W / p_elec_max 507 W gives u_decode ~ 0.41;
# TDP wall at 1305 MHz fixes p_elec_max = 507 W; u(theta) line through
# (0.97, 0.95) and (0.62, 0.412).
A100 = ChipSpec(
    name="a100-80g-sxm",
    peak_flops=312e12,
    hbm_bw=2039e9,
    hbm_bytes=80e9,
    gemm_eff=0.55,
    mem_eff=0.80,
    f_max=1410.0,
    f_min=510.0,
    f_volt_knee=1005.0,
    f_mem_knee=1005.0,
    volt_slope=0.365,
    mem_knee_gamma=0.5,
    mu_dram=0.56,
    p_idle=60.0,
    p_elec_max=507.0,
    tdp=400.0,
    u_k0=-0.541,
    u_k1=1.537,
    mxu_tile=256,  # paper Fig. 6: decode staircase period 256
    p_sleep=25.0,
    freq_levels_2=(1005.0, 1410.0),
    freq_levels_5=(1005.0, 1095.0, 1200.0, 1305.0, 1410.0),
)

# GH200 (H100 96G part).  Paper Appx. M: prefill sweet 1095 MHz, decode sweet
# 1395 MHz, f_max 1980 MHz, 900 W TDP wall hit by prefill near 1600 MHz.
# The split knees (volt 1095 / mem 1395) reproduce the phase-specific sweet
# spots mechanistically.
GH200 = ChipSpec(
    name="gh200",
    peak_flops=989e12,
    hbm_bw=4000e9,
    hbm_bytes=96e9,
    gemm_eff=0.55,
    mem_eff=0.80,
    f_max=1980.0,
    f_min=345.0,
    f_volt_knee=1095.0,
    f_mem_knee=1395.0,
    volt_slope=0.42,
    # strong DRAM-path penalty below the 1395 MHz knee — calibrated so the
    # decode sweet spot lands at ~1395 while prefill's stays at the
    # voltage knee ~1095 (paper Appx. M); HBM3e controller clocking
    # couples harder to the core domain than the A100's HBM2e.
    mem_knee_gamma=2.2,
    mu_dram=0.56,
    p_idle=120.0,
    p_elec_max=1150.0,
    tdp=900.0,
    u_k0=-0.541,
    u_k1=1.537,
    mxu_tile=256,
    p_sleep=45.0,
    freq_levels_2=(1095.0, 1980.0),  # F_P; F_D uses (1395, 1980)
    freq_levels_5=(1095.0, 1395.0, 1605.0, 1800.0, 1980.0),
)

# TPU v5e-class (the deployment target of this repo).  197 TFLOP/s bf16,
# 819 GB/s HBM, ~50 GB/s/link ICI (assignment constants).  TPUs do not expose
# a per-iteration clock API; these are *modeled* SoC operating points the
# controller selects among (DESIGN.md §2) — the control plane is identical.
# MXU is 128x128 => GEMM M-dim staircase period 128.
TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16e9,
    gemm_eff=0.65,
    mem_eff=0.80,
    f_max=940.0,
    f_min=340.0,
    f_volt_knee=670.0,  # 0.713 * f_max — same normalized knee as A100
    f_mem_knee=670.0,
    volt_slope=0.365,
    mem_knee_gamma=0.5,
    mu_dram=0.56,
    p_idle=35.0,
    p_elec_max=250.0,
    tdp=200.0,
    u_k0=-0.541,
    u_k1=1.537,
    mxu_tile=128,
    ici_bw=50e9,
    ici_links=4,
    p_sleep=12.0,
    freq_levels_2=(670.0, 940.0),
    freq_levels_5=(670.0, 730.0, 800.0, 870.0, 940.0),
)

CHIPS = {c.name: c for c in (A100, GH200, TPU_V5E)}


def get_chip(name: str) -> ChipSpec:
    if name not in CHIPS:
        raise KeyError(f"unknown chip {name!r}; available: {sorted(CHIPS)}")
    return CHIPS[name]
