from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_verify_attention_ref,
)
