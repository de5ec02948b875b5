from repro_torch.serving.autoscale import (  # noqa: F401
    AutoScaleConfig,
    AutoScaler,
    InstanceSpec,
    ScaleEvent,
    homogeneous_fleet,
)
from repro_torch.serving.cluster import ClusterConfig, PDCluster, build_predictor  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    DecodeEngine,
    HybridEngine,
    PrefillEngine,
    SimBackend,
    TierQueue,
)
from repro_torch.serving.kvpool import (  # noqa: F401
    BlockTable,
    KVPool,
    PageAllocError,
)
from repro_torch.serving.metrics import InstanceEnergy, RunMetrics  # noqa: F401
from repro_torch.serving.radixcache import PagedRadixCache, RadixCache  # noqa: F401
from repro_torch.serving.request import (  # noqa: F401
    BATCH,
    DEFAULT_TIERS,
    INTERACTIVE,
    Phase,
    Request,
    STANDARD,
    TierSpec,
    UNTIERED,
)
from repro_torch.serving.workload import (  # noqa: F401
    AZURE_CODE,
    AZURE_CONV,
    DATASETS,
    LMSYS,
    SHAREGPT,
    DatasetDist,
    LengthDist,
    attach_tokens,
    azure_like,
    multiturn_workload,
    poisson_workload,
    spec_heterogeneity_workload,
    step_load,
    synthetic_pd_ratio,
    tiered_workload,
)
from repro_torch.serving.traces import (  # noqa: F401
    AgenticSegment,
    DiurnalSegment,
    FlashCrowdSegment,
    TieredSegment,
    Trace,
    TraceRecord,
    load_azure_trace,
    load_burstgpt_trace,
    load_trace,
    rescale,
    rescale_to_rps,
    resample,
    synthetic_trace,
    tile,
    trace_from_requests,
)
from repro_torch.serving.loadgen import (  # noqa: F401
    FIFOServer,
    LoadPoint,
    OpenLoopDriver,
    attainment_knee,
    detect_knee,
    qps_sweep,
)
from repro_torch.serving.scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    run_scenario,
)
