# The paper's primary contribution: phase-specific per-iteration frequency
# control (EcoFreq), online-adaptive latency prediction (EcoPred), and
# state-space guided decode routing (EcoRoute), over the Eq. 1-3 power model
# and a roofline-calibrated hardware latency model.
from repro_torch.core.ecofreq import (  # noqa: F401
    BatchInfo,
    EcoFreq,
    IntervalFreq,
    PowerCapFreq,
    StaticFreq,
    SystemState,
)
from repro_torch.core.ecopred import EcoPred, ProfileRanges  # noqa: F401
from repro_torch.core.ecoroute import (  # noqa: F401
    CacheAffinityPrefillRouter,
    EcoRoute,
    EnergyAwareEcoRoute,
    EnergyAwarePrefillRouter,
    FaultTolerantRouter,
    InstanceProfile,
    InstanceView,
    RoundRobinRouter,
    RouteRequest,
)
from repro_torch.core.hwmodel import (  # noqa: F401
    HardwareModel,
    IterCost,
    IterWork,
    decode_work,
    energy_frequency_curve,
    iter_cost,
    prefill_chunk_work,
    prefill_work,
    sweet_spot,
)
from repro_torch.core.power import A100, CHIPS, GH200, TPU_V5E, ChipSpec, get_chip  # noqa: F401
