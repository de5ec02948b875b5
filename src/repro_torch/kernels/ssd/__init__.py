from repro_torch.kernels.ssd.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: F401
