"""Shared-exponent block floating point (paper §3.6; the reference's
``repro/core/bfp.py``).

Per block of ``block`` values along the chosen axis:
  e      = exponent of max|x| (frexp: max|x| = f * 2^e, f in [0.5, 1))
  q      = clip(round(x * 2^(bits-1-e)), -(2^(bits-1)-1), 2^(bits-1)-1)
  dequant= q * 2^(e-(bits-1))
``round`` is half-to-even and the clip comes before the cast, so a scaled
127.5 becomes 127, not a wrapped -128.  Blocks of zeros get e = 0, q = 0.
Max absolute error per element is 3*2^(e-bits) (:func:`error_bound`).

:func:`quantize_linear_tree` compresses a model's large linears for
serving (the reference's ``bfp8`` serving dtype); :func:`weight_of` and
``nn.layers.linear`` read them back.

Every power of two is built from its exponent bits (:func:`pow2`), never
with ``exp2``/``pow``, so the scales are exact on the CPU and on the card
alike and quantization gives the same bits on both.  Normal-range blocks
match the reference bit for bit; the reference's CPU backend flushes
subnormals to zero, so a block whose max lies below 2^-119 may not.
"""
from __future__ import annotations

import math

import torch


def pow2(n):
    """2^n as float32 for an integer tensor ``n``, exactly as C's
    ``ldexpf(1.0f, n)``: normal and subnormal powers from their bits, 0
    below 2^-149, inf above 2^127."""
    n = n.to(torch.int32)
    normal = (n.clamp(-126, 127) + 127) << 23
    sub = torch.ones_like(n) << (n.clamp(-149, -127) + 149)
    bits = torch.where(n >= -126, normal,
                       torch.where(n >= -149, sub, torch.zeros_like(n)))
    bits = torch.where(n > 127, torch.full_like(n, 0x7F800000), bits)
    return bits.view(torch.float32)


def _block_reshape(x, block: int, axis: int):
    axis = axis % x.ndim
    n = x.shape[axis]
    assert n % block == 0, f"axis size {n} not divisible by block {block}"
    shape = x.shape[:axis] + (n // block, block) + x.shape[axis + 1:]
    return x.reshape(shape), axis


def quantize(x, *, block: int = 32, bits: int = 8, axis: int = -1):
    """-> (mantissa int8/int16, exponent int8 per block, blocked axis)."""
    xb, axis = _block_reshape(x.to(torch.float32), block, axis)
    # max|x| without a |x| temporary: max(max x, -min x)
    amax = torch.maximum(xb.amax(dim=axis + 1, keepdim=True),
                         -xb.amin(dim=axis + 1, keepdim=True))
    _, e = torch.frexp(torch.where(amax > 0, amax, torch.ones_like(amax)))
    e = torch.where(amax > 0, e, torch.zeros_like(e))
    qmax = 2 ** (bits - 1) - 1
    m = (xb * pow2((bits - 1) - e)).round_().clamp_(-qmax, qmax)
    mdtype = torch.int8 if bits <= 8 else torch.int16
    return m.to(mdtype), e.squeeze(axis + 1).to(torch.int8), axis


def dequantize(m, e, *, bits: int = 8, axis: int | None = None):
    """Inverse of :func:`quantize`; ``axis`` is the blocked axis (of the
    block pair)."""
    if axis is None:
        axis = m.ndim - 2
    scale = pow2(e.to(torch.int32) - (bits - 1)).unsqueeze(axis + 1)
    x = m.to(torch.float32).mul_(scale)
    return x.reshape(x.shape[:axis] + (x.shape[axis] * x.shape[axis + 1],)
                     + x.shape[axis + 2:])


def quantize_dequantize(x, *, block: int = 32, bits: int = 8,
                        axis: int = -1):
    """``x`` rounded to BFP and back, in f32.  Its gradient is 0, the
    derivative of ``round`` (the reference's, whose cast to the integer
    mantissas differentiates to 0): a tensor that requires grad gets a
    zero gradient through here, where the integer ops of :func:`quantize`
    and :func:`pow2` would cut the graph and leave it none."""
    return _RoundTrip.apply(x, block, bits, axis)


class _RoundTrip(torch.autograd.Function):
    """:func:`quantize_dequantize` as one node with a zero backward."""

    @staticmethod
    def forward(ctx, x, block, bits, axis):
        ctx.dtype = x.dtype
        m, e, ax = quantize(x, block=block, bits=bits, axis=axis)
        return dequantize(m, e, bits=bits, axis=ax)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g, dtype=ctx.dtype), None, None, None


def bfp_matmul(x, w, *, block: int = 32, bits: int = 8):
    """(M,K) @ (K,N) with both operands quantized per K-block: the plain
    oracle of the shared-exponent dot product.  Integer mantissa products
    summed exactly within a block (in float64, which holds every such sum
    of 8- and 16-bit mantissas exactly), rescaled by 2^(e_x + e_w -
    2(bits-1)), then summed over the blocks in float32."""
    mx, ex, _ = quantize(x, block=block, bits=bits, axis=1)     # (M,KB,B)
    mw, ew, _ = quantize(w, block=block, bits=bits, axis=0)     # (KB,B,N)
    acc = torch.einsum("mkb,kbn->mkn", mx.double(),
                       mw.double()).to(torch.float32)
    scale = pow2(ex.to(torch.int32)[:, :, None]
                 + ew.to(torch.int32)[None, :, :] - 2 * (bits - 1))
    return (acc * scale).sum(dim=1)


# linears and (stacked) expert weights that quantize_linear_tree compresses
QKEYS = ("w", "w1", "w2", "w3")


def quantizable(v, *, block: int = 64, min_size: int = 1 << 16,
                stack: int = 0) -> bool:
    """A floating tensor of 2-4 dimensions, at least ``min_size``
    elements, its axis ``ndim - 2`` a whole number of blocks.  With
    ``stack`` = n, ``v`` is one layer of a stack of n that the reference
    holds as one leaf with a leading axis of n (its scan groups), and the
    rule is applied to that leaf."""
    if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
        return False
    shape = ((stack,) if stack else ()) + tuple(v.shape)
    return (len(shape) in (2, 3, 4) and math.prod(shape) >= min_size
            and shape[-2] % block == 0)


def quantize_linear_tree(params, *, block: int = 64, bits: int = 8,
                         min_size: int = 1 << 16, stack: int = 0):
    """Serving-time weight compression (paper §3.6 on the decode weight
    stream), the reference's: every :func:`quantizable` leaf under a
    :data:`QKEYS` key, {"w": (.., K, N)}, becomes {"w_q": int8 (.., KB,
    block, N), "w_e": int8 (.., KB, N)}, blocked along its axis ``ndim -
    2`` (K); every other leaf is kept as it is (the same tensor).
    ``linear`` and :func:`weight_of` dequantize transparently.  ``stack``:
    as in :func:`quantizable` (``models.lm.quantize_linear_tree`` passes
    it for the layers the reference stacks); the blocks, along K, are the
    same either way.  ``linear`` and :func:`weight_of` dequantize at 8
    bits, as the reference's do: a tree of other ``bits`` is read with
    :func:`dequantize_linear` at those bits."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in QKEYS and quantizable(v, block=block,
                                              min_size=min_size,
                                              stack=stack):
                    m, e, _ = quantize(v, block=block, bits=bits,
                                       axis=v.ndim - 2)
                    out[k + "_q"] = m
                    out[k + "_e"] = e
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def dequantize_linear(p, key: str = "w", *, bits: int = 8):
    """The (.., K, N) f32 weight of a quantized param dict."""
    m = p[key + "_q"]
    return dequantize(m, p[key + "_e"], bits=bits, axis=m.ndim - 3)


def weight_of(p, key: str = "w", dtype=None):
    """The raw or dequantized weight of a (possibly BFP-compressed) dict,
    cast to ``dtype`` if given."""
    w = dequantize_linear(p, key) if key + "_q" in p else p[key]
    return w.to(dtype) if dtype is not None else w


def error_bound(e, *, bits: int = 8):
    """Per-element max abs quantization error given block exponents: half
    a step from rounding plus up to one step from clipping the block max,
    1.5 * 2^(e-(bits-1)) = 3 * 2^(e-bits)."""
    return 3.0 * pow2(e.to(torch.int32) - bits)
