"""Oracle for the SSD kernel: the token-by-token recurrence (the
reference's ``repro/kernels/ssd/ref.py``).

h_t = h_{t-1} * exp(dt_t * A) + B_t^T (dt_t x_t);   y_t = C_t h_t
"""
from __future__ import annotations

import torch


def ssd_reference(x, dt, A, B_, C_):
    """x (B,L,H,P); dt (B,L,H); A (H,); B_,C_ (B,L,G,N) ->
    (y (B,L,H,P) in x's dtype, final_state (B,H,N,P) f32).  O(L)
    sequential scan, f32 throughout."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    gmap = torch.arange(H, device=x.device) // (H // G)
    xf, dtf = x.float(), dt.float()
    bh, ch = B_.float()[:, :, gmap], C_.float()[:, :, gmap]   # (B,L,H,N)
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * A.float())                   # (B,H)
        h = h * dA[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bh[:, t], dtf[:, t, :, None] * xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h
