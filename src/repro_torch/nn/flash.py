"""Blockwise (flash-style) attention with its flash backward (the
reference's ``repro/nn/flash.py``), and the one-token decode attention of
the serving engine.

:func:`flash_attention` is plain PyTorch: in the reference it is pure JAX,
not a Pallas kernel.  It walks (q_chunk x k_chunk) tiles with an online
softmax, so the (S x S) score matrix is never materialized, and casts each
probability tile to v's dtype before the PV product, as the reference
does.  The backward recomputes the probability tiles from the saved
log-sum-exp (saving only q, k, v, o and lse), as the reference's custom
VJP does.  ``banded`` computes only the lower-triangle chunk pairs of
causal self-attention; the skipped tiles are fully masked, so the result
is the same function.  GQA is handled by grouping the query heads of one
KV head; KV heads are never repeated.

The forward and backward are one ``torch.library`` op
(``repro_torch::flash_fwd``) with an autograd rule, so selective
activation checkpointing can keep its output (``remat_policy="save_attn"``,
``nn/blocks.py``).  On meta tensors the op gives its outputs' shapes
(a fake implementation), and the dry run's counter counts the ops of
``_fwd`` (``core/opcount.py``).

:func:`decode_attention` runs kernel 5 (``csrc/decode_attn.cu``) on a CUDA
tensor and its plain version on a CPU tensor.

Under tensor-parallel compute over ``model`` the sequence-parallel
regime (``nn/attention.py``) gives :func:`flash_attention` the rank's block
of q rows with ``q_offset`` = rank x S / model, and a decode gives kernel 5
the rank's block of the cache, merged across the ranks by the log-sum-exp
``return_lse`` returns (``kernels/decode_attn/ref.py::merge_blocks``).

Layouts: q (B, Sq, H, D); k, v (B, Skv, KV, D) with H % KV == 0.
"""
from __future__ import annotations

import torch

from ..core import opcount
from ..kernels.decode_attn import ops as _decode_ops
from ..kernels.decode_attn.ref import NEG_INF, prescale

# the reference's tile sizes: in bf16 the tiling is part of the function
# (each probability tile is rounded against its running max)
Q_CHUNK, K_CHUNK = 512, 1024


def _pad_to(x, n, dim):
    pad = n - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _grouped(t, KV, lo, hi):
    """Rows [lo, hi) of a (B, S, H, ...) tensor as (B, KV, G, rows, ...):
    the query heads of one KV head together."""
    B, _, H = t.shape[:3]
    t = t[:, lo:hi]
    t = t.reshape(B, hi - lo, KV, H // KV, *t.shape[3:])
    return t.movedim(1, 3)


def _mask(q_pos, k_pos, causal, kv_valid):
    m = k_pos[None, :] < kv_valid
    if causal:
        m = m & (q_pos[:, None] >= k_pos[None, :])
    return m


def _skip(banded, qi, ki):
    """A banded schedule computes only the chunk pairs with ki <= qi."""
    return banded and ki > qi


def _fwd(q, k, v, causal, q_offset, q_chunk, k_chunk, kv_valid, banded):
    """(o (B,Sq,H,D) f32, lse (B,Sq,H) f32) of pre-padded shapes."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    nq, nk = Sq // q_chunk, Skv // k_chunk
    qs = prescale(q)
    kf = k.to(torch.float32)
    dev = q.device
    o_all = torch.empty((B, Sq, H, D), dtype=torch.float32, device=dev)
    lse_all = torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
    for qi in range(nq):
        lo, hi = qi * q_chunk, (qi + 1) * q_chunk
        qb = _grouped(qs, KV, lo, hi).to(torch.float32)   # (B,KV,G,qc,D)
        q_pos = q_offset + lo + torch.arange(q_chunk, device=dev)
        o = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32,
                        device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if _skip(banded, qi, ki):
                continue
            kb = kf[:, ki * k_chunk:(ki + 1) * k_chunk]       # (B,kc,KV,D)
            vb = v[:, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bkgqd,bskd->bkgqs", qb, kb)
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.where(_mask(q_pos, k_pos, causal, kv_valid), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # probability tiles in v's dtype; the row sums and the PV
            # product accumulate in f32
            p = torch.exp(s - m_new[..., None]).to(vb.dtype)
            corr = torch.exp(m - m_new)
            pf = p.to(torch.float32)
            l = l * corr + pf.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", pf, vb.to(torch.float32))
            m = m_new
        l = torch.clamp(l, min=1e-30)
        o_all[:, lo:hi] = (o / l[..., None]).movedim(3, 1).reshape(
            B, q_chunk, H, D)
        lse_all[:, lo:hi] = (m + torch.log(l)).movedim(3, 1).reshape(
            B, q_chunk, H)
    return o_all, lse_all


def _bwd(q, k, v, o, lse, do, causal, q_offset, q_chunk, k_chunk, kv_valid,
         banded):
    """(dq, dk, dv) f32 of pre-padded shapes: the probability tiles
    recomputed from lse, k-block outer, q-block inner, as the reference."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    nq, nk = Sq // q_chunk, Skv // k_chunk
    scale = D ** -0.5
    dev = q.device
    do = do.to(torch.float32)
    delta = torch.sum(do * o, dim=-1)                       # (B,Sq,H)
    qs = prescale(q)
    dq = torch.zeros((B, KV, H // KV, Sq, D), dtype=torch.float32,
                     device=dev)
    dk = torch.empty((B, Skv, KV, D), dtype=torch.float32, device=dev)
    dv = torch.empty((B, Skv, KV, D), dtype=torch.float32, device=dev)
    for ki in range(nk):
        klo, khi = ki * k_chunk, (ki + 1) * k_chunk
        kb = k[:, klo:khi].to(torch.float32)                 # (B,kc,KV,D)
        vb = v[:, klo:khi]
        vbf = vb.to(torch.float32)
        k_pos = klo + torch.arange(k_chunk, device=dev)
        dk_acc = torch.zeros((B, k_chunk, KV, D), dtype=torch.float32,
                             device=dev)
        dv_acc = torch.zeros_like(dk_acc)
        for qi in range(nq):
            if _skip(banded, qi, ki):
                continue
            lo, hi = qi * q_chunk, (qi + 1) * q_chunk
            qb = _grouped(qs, KV, lo, hi).to(torch.float32)
            dob = _grouped(do, KV, lo, hi)
            lseb = _grouped(lse, KV, lo, hi)
            deb = _grouped(delta, KV, lo, hi)
            q_pos = q_offset + lo + torch.arange(q_chunk, device=dev)
            s = torch.einsum("bkgqd,bskd->bkgqs", qb, kb)
            s = torch.where(_mask(q_pos, k_pos, causal, kv_valid), s,
                            NEG_INF)
            # probability and ds tiles in v's dtype, f32 accumulation
            p = torch.exp(s - lseb[..., None]).to(vb.dtype)
            pf = p.to(torch.float32)
            dv_acc = dv_acc + torch.einsum("bkgqs,bkgqd->bskd", pf, dob)
            dp = torch.einsum("bkgqd,bskd->bkgqs", dob, vbf)
            ds = (pf * (dp - deb[..., None])).to(vb.dtype).to(torch.float32)
            # qb is pre-scaled by D^-0.5, which is exactly dk's scale
            dk_acc = dk_acc + torch.einsum("bkgqs,bkgqd->bskd", ds, qb)
            dq[:, :, :, lo:hi] += torch.einsum(
                "bkgqs,bskd->bkgqd", ds, kb) * scale
        dk[:, klo:khi] = dk_acc
        dv[:, klo:khi] = dv_acc
    dq = dq.movedim(3, 1).reshape(B, Sq, H, D)
    return dq, dk, dv


@torch.library.custom_op(
    "repro_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int q_offset, "
           "int q_chunk, int k_chunk, int kv_valid, bool banded) "
           "-> (Tensor, Tensor)")
def _flash_op(q, k, v, causal, q_offset, q_chunk, k_chunk, kv_valid,
              banded):
    return _fwd(q, k, v, causal, q_offset, q_chunk, k_chunk, kv_valid,
                banded)


def _flash_setup(ctx, inputs, output):
    q, k, v, *args = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = args


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _bwd(q, k, v, o, lse, do, *ctx.args)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            None, None, None, None, None, None)


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, q_offset, q_chunk, k_chunk, kv_valid,
                banded):
    """(o, lse) of ``_fwd``'s shapes on meta (or fake) tensors, computing
    nothing; the dry run's counter counts ``_fwd``'s own ops instead."""
    B, Sq, H, D = q.shape
    return (q.new_empty((B, Sq, H, D), dtype=torch.float32),
            q.new_empty((B, Sq, H), dtype=torch.float32))

# the op whose output remat_policy="save_attn" keeps
FLASH_OP = torch.ops.repro_torch.flash_fwd.default
# the card runs the op's body op by op: the dry run counts those ops
opcount.open_op(FLASH_OP, _fwd)


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    q_chunk: int = Q_CHUNK, k_chunk: int = K_CHUNK,
                    kv_valid_len=None, banded: bool = False):
    """Online-softmax blockwise attention with the flash backward.

    q_offset: absolute position of q[0] relative to k[0].  kv_valid_len:
    mask kv positions >= this.  banded=True computes only lower-triangle
    chunk pairs for causal self-attention (one chunk size, min(q_chunk,
    Sq)).  Returns (B, Sq, H, D) in q.dtype."""
    Sq, Skv = q.shape[1], k.shape[1]
    kv_valid = Skv if kv_valid_len is None else int(kv_valid_len)
    band = banded and causal and q_offset == 0 and Sq == Skv
    if band:
        q_chunk = k_chunk = min(q_chunk, Sq)
    else:
        q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Skv)
    nq, nk = -(-Sq // q_chunk), -(-Skv // k_chunk)
    o, _ = _flash_op(_pad_to(q, nq * q_chunk, 1), _pad_to(k, nk * k_chunk, 1),
                     _pad_to(v, nk * k_chunk, 1), causal, int(q_offset),
                     q_chunk, k_chunk, kv_valid, band)
    return o[:, :Sq].to(q.dtype)


def decode_attention(q, k_cache, v_cache, length, return_lse: bool = False):
    """One-token decode: q (B, 1, H, D) against the cache (B, S, KV, D);
    positions >= length (a scalar or a (B,) tensor) are masked.  Kernel 5
    on a CUDA tensor, its plain version (the reference's grouped einsum) on
    a CPU tensor.  ``return_lse``: also the f32 log-sum-exp (B, H), for
    one rank's block of a cache split along the sequence (an empty block:
    output 0, lse -inf)."""
    return _decode_ops.decode_attention(q, k_cache, v_cache, length,
                                        return_lse=return_lse)
