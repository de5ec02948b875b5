"""Plain-PyTorch version of the SSD scan kernel: the token recurrence.

The SSD chunked algorithm is algebraically exact for the underlying
linear recurrence, so this direct per-token scan is the ground truth:

    state_t = exp(dt_t * A) * state_{t-1} + dt_t * B_t (outer) x_t
    y_t     = C_t . state_t
"""
from __future__ import annotations

import torch


def ssd_decode_step(
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H) fp32 post-softplus
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
    state: torch.Tensor,  # (B, H, P, N) fp32
):
    """Single-token SSD recurrence. Returns (y (B,H,P), new_state)."""
    xf = x.float()
    dec = torch.exp(dt * A)  # (B, H)
    # dt_h x_hp B_n, broadcast: a three-operand einsum costs PyTorch some
    # twenty view ops a call, and decode makes this call once per layer
    upd = (dt[:, :, None] * xf)[..., None] * Bm.float()[:, None, None, :]
    new_state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32 post-softplus
    A: torch.Tensor,  # (H,) fp32 negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
):
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32),
    from a zero state."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        y, state = ssd_decode_step(x[:, t], dt[:, t].float(), A, Bm[:, t],
                                   Cm[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state
