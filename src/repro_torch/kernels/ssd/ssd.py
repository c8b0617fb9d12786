"""Kernel 6, the chunked Mamba-2 SSD scan: the port of the reference's
``_ssd_kernel`` (``repro/kernels/ssd/ssd.py:25``), every layer's prefill.

:func:`ssd_chunked_pallas` runs ``csrc/ssd.cu`` on a CUDA tensor and the
plain version :func:`ssd_chunked_plain` on a CPU tensor; a failed launch
raises :class:`build.KernelError`, and nothing falls back.  Both compute
the TPU kernel's function: per (batch, head), chunks of Q = min(chunk, L)
tokens in order, f32 throughout, every exponent clipped to [-60, 0], the
(N, P) state carried from chunk to chunk and returned in f32, y rounded to
x's dtype once.  Rows past L count as zeros with dt = 0, so the padding
adds nothing to the state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# what csrc/ssd.cu is built for: its per-block tiles hold P <= 64 and
# N <= 256 in shared memory
KERNEL_MAX_P = 64
KERNEL_MAX_N = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def clip_exp(t):
    return torch.exp(torch.clamp(t, -60.0, 0.0))


def _cumsum_seq(t, dim: int):
    """Inclusive prefix sum along ``dim`` in f32, one term at a time in
    order: the kernel's sum, so both versions see the same decays (a
    parallel scan's other order moves cums near -60 by several ulps, and
    exp(cums_i - cums_k) by as much relative)."""
    parts = t.unbind(dim)
    out, run = [], torch.zeros_like(parts[0])
    for part in parts:
        run = run + part
        out.append(run)
    return torch.stack(out, dim=dim)


def _check_args(x, dt, A, B_, C_):
    if x.ndim != 4 or dt.ndim != 3 or B_.ndim != 4:
        raise ValueError(f"ssd_chunked: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B_.shape)} are not "
                         "(B,L,H,P), (B,L,H), (B,L,G,N)")
    Bb, L, H, P = x.shape
    G = B_.shape[2]
    if tuple(dt.shape) != (Bb, L, H) or tuple(A.shape) != (H,) \
            or B_.shape[:2] != (Bb, L) or C_.shape != B_.shape \
            or G == 0 or H % G:
        raise ValueError(f"ssd_chunked: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)} do not fit"
                         " (H % G == 0)")


def ssd_chunked_plain(x, dt, A, B_, C_, *, chunk: int = 256):
    """Kernel 6's function in PyTorch.  x (B,L,H,P); dt (B,L,H)
    post-softplus; A (H,); B_, C_ (B,L,G,N) -> (y (B,L,H,P) in x's dtype,
    final_state (B,H,N,P) f32)."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, L)
    pad = (-L) % Q
    nc = (L + pad) // Q
    gmap = torch.arange(H, device=x.device) // (H // G)
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bb, nc, Q, H)
    bf = F.pad(B_.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, G, N)
    cf = F.pad(C_.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, G, N)
    cums = _cumsum_seq(dtf * A.float(), dim=2)                  # (B,nc,Q,H)

    # intra-chunk: M[q,k] = (C_q . B_k) * exp(cums_q - cums_k) * dt_k, k<=q
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cf, bf)[:, :, gmap]  # (B,nc,H,Q,Q)
    t = cums.permute(0, 1, 3, 2)                                 # (B,nc,H,Q)
    dec = clip_exp(t[..., :, None] - t[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    m = torch.where(causal, cb * dec, 0.0) * \
        dtf.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xf)

    # inter-chunk, chunk by chunk: y += (C * exp(cums)) @ state, then
    # state = lam * state + (B * exp(cums_last - cums) * dt)^T @ x
    bh, ch = bf[:, :, :, gmap], cf[:, :, :, gmap]                # (B,nc,Q,H,N)
    state = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    for c in range(nc):
        cc = cums[:, c]                                          # (B,Q,H)
        c_dec = ch[:, c] * clip_exp(cc)[..., None]
        y[:, c] += torch.einsum("bqhn,bhnp->bqhp", c_dec, state)
        lam = clip_exp(cc[:, -1])                               # (B,H)
        b_dec = bh[:, c] * (clip_exp(cc[:, -1:] - cc) * dtf[:, c])[..., None]
        state = lam[..., None, None] * state + torch.einsum(
            "bkhn,bkhp->bhnp", b_dec, xf[:, c])
    return y.reshape(Bb, nc * Q, H, P)[:, :L].to(x.dtype), state


def _ssd_cuda(x, dt, A, B_, C_, chunk: int):
    global launches
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if x.dtype not in _DTYPE_CODE or P > KERNEL_MAX_P or N > KERNEL_MAX_N:
        raise ValueError(f"ssd_chunked: the kernel takes {list(_DTYPE_CODE)}"
                         f" at P <= {KERNEL_MAX_P}, N <= {KERNEL_MAX_N}; got "
                         f"{x.dtype}, P={P}, N={N}")
    for t in (B_, C_):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_chunked: B and C must be {x.dtype} like "
                             f"x; got {t.dtype}")
    x, B_, C_ = (t.contiguous() for t in (x, B_, C_))
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    for t in (dt, A, B_, C_):
        if t.device != x.device:
            raise ValueError(f"ssd_chunked: an input on {t.device}, x on "
                             f"{x.device}")
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    err = build.library().lib.repro_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), y.data_ptr(), state.data_ptr(), Bb, L, H, P, G, N,
        min(chunk, L), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd")
    launches += 1
    return y, state


def ssd_chunked_pallas(x, dt, A, B_, C_, *, chunk: int = 256):
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,); B_,C_ (B,L,G,N).
    Returns (y (B,L,H,P) in x's dtype, final_state (B,H,N,P) f32)."""
    _check_args(x, dt, A, B_, C_)
    if chunk < 1:
        raise ValueError(f"ssd_chunked: chunk {chunk} < 1")
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, B_, C_, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    return _ssd_cuda(x, dt, A, B_, C_, chunk)
