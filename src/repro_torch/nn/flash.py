"""Blockwise (flash-style) attention, forward only (the reference's
``repro/nn/flash.py``), and the one-token decode attention of the serving
engine.

:func:`flash_attention` is plain PyTorch: in the reference it is pure JAX,
not a Pallas kernel.  It walks (q_chunk x k_chunk) tiles with an online
softmax, so the (S x S) score matrix is never materialized, and casts each
probability tile to v's dtype before the PV product, as the reference
does.  GQA is handled by grouping the query heads of one KV head; KV heads
are never repeated.  The backward pass comes with the training slice
(ROADMAP Queue 1, item 7d); the reference's banded variant computes the
same function with fewer tiles.

:func:`decode_attention` runs kernel 5 (``csrc/decode_attn.cu``) on a CUDA
tensor and its plain version on a CPU tensor.

Layouts: q (B, Sq, H, D); k, v (B, Skv, KV, D) with H % KV == 0.
"""
from __future__ import annotations

import torch

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


def flash_attention(q, k, v, *, causal: bool):
    """Online-softmax blockwise attention, forward only, with q and k
    starting at the same position.  Returns (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    q_chunk, k_chunk = min(Q_CHUNK, Sq), min(K_CHUNK, Skv)
    nq, nk = -(-Sq // q_chunk), -(-Skv // k_chunk)
    qp = _pad_to(prescale(q), nq * q_chunk, 1)
    kp = _pad_to(k, nk * k_chunk, 1).to(torch.float32)
    vp = _pad_to(v, nk * k_chunk, 1)
    dev = q.device
    outs = []
    for qi in range(nq):
        # (B, KV, G, qc, D): the query heads of one KV head together
        qb = qp[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(
            B, q_chunk, KV, G, D).permute(0, 2, 3, 1, 4).to(torch.float32)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        o = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32,
                        device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb = kp[:, ki * k_chunk:(ki + 1) * k_chunk]       # (B,kc,KV,D)
            vb = vp[:, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bkgqd,bskd->bkgqs", qb, kb)
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            mask = k_pos[None, :] < Skv
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(mask, s, NEG_INF)
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
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def decode_attention(q, k_cache, v_cache, length):
    """One-token decode: q (B, 1, H, D) against the cache (B, S, KV, D);
    positions >= length (a scalar or a (B,) tensor) are masked.  Kernel 5
    on a CUDA tensor, its plain version (the reference's grouped einsum) on
    a CPU tensor."""
    return _decode_ops.decode_attention(q, k_cache, v_cache, length)
