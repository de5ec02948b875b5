from repro_torch.kernels.ssd.ops import ssd_backward, ssd_scan  # noqa: F401
from repro_torch.kernels.ssd.ref import ssd_backward_ref, ssd_ref  # noqa: F401
