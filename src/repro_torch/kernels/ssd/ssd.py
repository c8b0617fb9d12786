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

The kernel is the chunk-parallel form of the scan in two to four launches
(the header of ``csrc/ssd.cu``); its launch geometry and scratch are here, as
functions of the shape: :func:`row_tile`, :func:`state_slice`,
:func:`ssd_grids`, :func:`scratch_numel` and :func:`smem_bytes`.
:func:`ssd_chunked_staged` computes the same stages in PyTorch, for the
tests.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ...core import opcount
from .. import build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# what csrc/ssd.cu is built for: its tiles hold P <= 64 head-dim columns,
# and N <= 256
KERNEL_MAX_P = 64
KERNEL_MAX_N = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's blocking (csrc/ssd.cu)
KEY_STEP = 32           # the K step of every product (keys or state rows)
CB_TILE = 64            # C.B^T tiles, and Q's padding (Qp)
STAGES = 2              # the cp.async ring's depth
PASS_THREADS = 256
# rows of y a y block computes (ROW_TILES) and state rows a state block
# computes (STATE_SLICES): each the largest whose blocks number MIN_BLOCKS
# (two an SM on the H100's 132), else the smallest
ROW_TILES = (64, 32)
STATE_SLICES = (64, 32)
MIN_BLOCKS = 264
MAX_SMEM = 227 * 1024
MAX_GRID = 2 ** 31 - 1


def tile_threads(rows: int) -> int:
    """A thread computes 8 rows x 4 columns of its block's rows x 64 tile."""
    return rows // 8 * 16


def chunks(L: int, Q: int) -> int:
    return -(-L // Q)


def padded_chunk(Q: int) -> int:
    """Qp: Q rounded up to a whole C.B^T tile."""
    return -(-Q // CB_TILE) * CB_TILE


def cb_tiles(Qp: int, rows: int) -> int:
    """C.B^T tiles of a (batch, group, chunk) with ``rows`` rows each: row
    tile t holds the key tiles 0 .. t * rows // CB_TILE."""
    return sum(t * rows // CB_TILE + 1 for t in range(Qp // rows))


def _pick(tiles, blocks_of) -> int:
    for t in tiles:
        if blocks_of(t) >= MIN_BLOCKS:
            return t
    return tiles[-1]


@functools.lru_cache(maxsize=None)
def row_tile(B: int, L: int, H: int, Q: int) -> int:
    """Rows of y a block computes.  A function of the shape only."""
    return _pick(ROW_TILES,
                 lambda t: B * chunks(L, Q) * H * math.ceil(Q / t))


@functools.lru_cache(maxsize=None)
def state_slice(B: int, L: int, H: int, N: int, Q: int) -> int:
    """State rows (of N) a block computes; with one chunk the row tile, as
    chunk 0's y blocks share the state blocks' launch.  A function of the
    shape only."""
    if chunks(L, Q) == 1:
        return row_tile(B, L, H, Q)
    return _pick(STATE_SLICES,
                 lambda t: B * chunks(L, Q) * H * math.ceil(N / t))


def ssd_grids(B, L, H, P, G, N, Q, rows, nslice) -> dict:
    """Each launch's (blocks, threads), as ``csrc/ssd.cu`` launches them.
    One chunk: ``cb`` (the C.B^T tiles), then ``front`` (chunk 0's y
    blocks beside the state blocks; rows == nslice).  Two chunks or more:
    ``front`` (the C.B^T tiles beside the state blocks), ``pass`` (the
    state pass) and ``y`` (every chunk's y blocks)."""
    nc, Qp = chunks(L, Q), padded_chunk(Q)
    n_cb = B * G * nc * cb_tiles(Qp, nslice)
    n_st = B * nc * H * math.ceil(N / nslice)
    threads = tile_threads(nslice)
    if nc == 1:
        return {"cb": (n_cb, threads),
                "front": (B * H * math.ceil(Q / nslice) + n_st, threads)}
    return {"front": (n_cb + n_st, threads),
            "pass": (math.ceil(B * H * N * P / PASS_THREADS), PASS_THREADS),
            "y": (B * nc * H * math.ceil(Q / rows), tile_threads(rows))}


def _align64(n: int) -> int:
    return -(-n // 64) * 64


def scratch_parts(B, L, H, P, G, N, Q) -> dict:
    """The f32 words of each part of the kernel's scratch, in order: lam
    (B, nc, H), C.B^T (B, G, nc, Qp, Qp), and with two chunks or more the
    states (B, H, nc, N, P): each chunk's dS, then the state entering it."""
    nc, Qp = chunks(L, Q), padded_chunk(Q)
    return {"lam": _align64(B * nc * H),
            "cb": _align64(B * G * nc * Qp * Qp),
            "states": B * H * nc * N * P if nc > 1 else 0}


def scratch_numel(B, L, H, P, G, N, Q) -> int:
    return sum(scratch_parts(B, L, H, P, G, N, Q).values())


def smem_bytes(L: int, Q: int, itemsize: int, rows: int,
               nslice: int) -> dict:
    """Each launch's dynamic shared memory, as ``csrc/ssd.cu`` sizes it:
    ``cb`` (one chunk's C.B^T launch), ``front``, ``pass`` and ``y``."""
    Qp = padded_chunk(Q)

    def raw(cols, size):            # a raw tile's row, 16 bytes of pad
        return (cols + 16 // size) * size

    def y_smem(r, stash):
        stage = max(KEY_STEP * raw(r, 4) + KEY_STEP * raw(64, itemsize),
                    r * raw(KEY_STEP, itemsize) + KEY_STEP * raw(64, 4))
        # the y launch keeps M @ x (r x 64) while the state term runs
        return STAGES * stage + (KEY_STEP * r + KEY_STEP * 64 + r + 2 * Qp
                                 + (r * 64 if stash else 0)) * 4
    cb = (STAGES * (nslice + CB_TILE) * raw(KEY_STEP, itemsize)
          + KEY_STEP * (nslice + CB_TILE) * 4)
    state = (STAGES * KEY_STEP * (raw(nslice, itemsize) + raw(64, itemsize))
             + (KEY_STEP * nslice + KEY_STEP * 64 + 3 * Qp) * 4)
    return {"cb": cb, "front": max(cb, state, y_smem(nslice, False)),
            "pass": 0, "y": y_smem(rows, True)}


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


def ssd_chunked_staged(x, dt, A, B_, C_, *, chunk: int = 256):
    """Kernel 6's function computed in the kernel's stages, in PyTorch (the
    tests hold it against :func:`ssd_chunked_plain` and the reference; no
    path calls it): 1. the decays (cums, w, lam) per (batch, chunk, head);
    2. C.B^T once per (batch, group, chunk) over the causal triangle;
    3. each chunk's own state contribution dS = (B o w)^T x, all chunks at
    once; 4. the state pass S_c = lam_c S_{c-1} + dS_c, keeping the state
    that enters each chunk; 5. y = M @ x plus (C o e(cums)) @ S_in from the
    second chunk on.  Returns (y in x's dtype, final state in f32)."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, L)
    nc = chunks(L, Q)
    pad = nc * Q - L
    gmap = torch.arange(H, device=x.device) // (H // G)
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bb, nc, Q, H)
    bf = F.pad(B_.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, G, N)
    cf = F.pad(C_.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, G, N)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()

    cums = _cumsum_seq(dtf * A.float(), dim=2)                  # 1
    last = cums[:, :, -1:]
    w = clip_exp(last - cums) * dtf                              # (B,nc,Q,H)
    lam = clip_exp(last[:, :, 0])                                # (B,nc,H)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cf, bf)              # 2
    ds = torch.einsum("bckhn,bckhp->bchnp",                      # 3
                      bf[:, :, :, gmap] * w[..., None], xf)
    state = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):                                          # 4
        s_in.append(state)
        state = lam[:, c, :, None, None] * state + ds[:, c]
    t = cums.permute(0, 1, 3, 2)                                 # 5
    m = torch.where(causal, cb[:, :, gmap]
                    * clip_exp(t[..., :, None] - t[..., None, :])
                    * dtf.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xf)
    for c in range(1, nc):
        c_dec = cf[:, c][:, :, gmap] * clip_exp(cums[:, c])[..., None]
        y[:, c] += torch.einsum("bqhn,bhnp->bqhp", c_dec, s_in[c])
    return y.reshape(Bb, nc * Q, H, P)[:, :L].to(x.dtype), state


def ssd_work(B, L, H, P, G, N, Q, itemsize):
    """(operations, bytes) one SSD scan needs, 2 operations a multiply-add:
    per batch row and chunk of q real rows (the last chunk may be short;
    padded rows are not counted), C.B^T once per group over the causal
    triangle (q(q+1)/2 x N), and per head the causal M @ x (q(q+1)/2 x P),
    the carried state's term (C e) @ S (q x N x P, from the second chunk
    on: the first starts from a zero state) and the state update
    B_dec^T @ x (q x N x P); the exponentials and the mask are not
    counted.  Bytes: x, B, C and y in x's dtype, dt, A and the final
    state in f32, once each."""
    rows = [min(Q, L - c * Q) for c in range(-(-L // Q))]
    tri = sum(q * (q + 1) // 2 for q in rows)
    flops = 2 * B * (G * tri * N + H * (tri * P + (2 * L - rows[0]) * N * P))
    nbytes = (itemsize * (2 * B * L * H * P + 2 * B * L * G * N)
              + 4 * (B * L * H + H + B * H * N * P))
    return flops, nbytes


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
    Q = min(chunk, L)
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_numel(Bb, L, H, P, G, N, Q),
                          dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        opcount.record_kernel("ssd", *ssd_work(Bb, L, H, P, G, N, Q,
                                               x.element_size()))
        return y, state
    err = build.library().lib.repro_ssd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        Bb, L, H, P, G, N, Q, row_tile(Bb, L, H, Q),
        state_slice(Bb, L, H, N, Q), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd")
    launches += 1
    return y, state


def ssd_chunked_pallas(x, dt, A, B_, C_, *, chunk: int = 256):
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,); B_,C_ (B,L,G,N).
    Returns (y (B,L,H,P) in x's dtype, final_state (B,H,N,P) f32).  On
    meta tensors (the dry run): the CUDA path's outputs and scratch, its
    launch recorded with :func:`ssd_work`."""
    _check_args(x, dt, A, B_, C_)
    if chunk < 1:
        raise ValueError(f"ssd_chunked: chunk {chunk} < 1")
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, B_, C_, chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    return _ssd_cuda(x, dt, A, B_, C_, chunk)
