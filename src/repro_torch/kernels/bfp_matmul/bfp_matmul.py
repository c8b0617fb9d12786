"""Shared-exponent block-FP matmul (paper §3.6): the port of the reference's
``_bfp_kernel`` (``repro/kernels/bfp_matmul/bfp_matmul.py``), AlexNet's
fc6-fc8 under ``fc_bfp``.

x (M, K) f32 (or bf16, which the pre-pass widens exactly as it reads it:
the bits of the f32 kernel on ``x.float()``) is quantized per (row,
K-block) to int8 mantissas with a shared exponent; each K-block's integer
dot with the pre-quantized weight mantissas is rescaled by 2^(e_x + e_w -
14) into one f32 sum per output, over the K-blocks in ascending order.

The staged weight stream has the port's own layout: ``wq`` (K/G, N, G) int8
holds G = gcd(block, 4) consecutive k of one column together (4 for every
block the kernel takes: one 32-bit word, coalesced across a warp's
columns), ``we`` (KB, N) int8 the exponents.  :func:`reference_layout`
gives the reference's (KB, block, N) mantissas back.

:func:`bfp_matmul` runs ``csrc/bfp_matmul.cu`` on a CUDA tensor and its
plain PyTorch version, :func:`bfp_matmul_plain`, on a CPU tensor; the
plain version takes the kernel's exact arguments and gives its bits.

The kernel is two launches: a pre-pass quantizes x once into the wrapper's
scratch (:func:`quantize_activations` is its plain twin, byte for byte),
then a GEMM streams the weights over blocks of 8 rows by
:func:`tile_cols` columns (:func:`bfp_grid`, :func:`scratch_shapes`), 8
warps a block taking one K-block each a round.
"""
from __future__ import annotations

import math

import torch

from ...core import bfp
from .. import build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

# x's element types the pre-pass reads, and their codes in the C entry
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# exponent-block sizes the kernel is built for; mantissas are int8
KERNEL_BLOCKS = (16, 32)
BITS = 8
# the exponent of a K-block of x that holds a NaN or an infinity, as the
# pre-pass writes it (csrc/bfp_matmul.cu kBad)
BAD_EXPONENT = 1 << 20
# the GEMM's blocking: x rows a block (one 8-row A tile), and the column
# tiles it is built for (one warp per 8 columns); the widest tile whose
# grid has MIN_BLOCKS blocks is taken (132 SMs on the H100)
TILE_ROWS = 8
TILE_COLS = (16, 8)
MIN_BLOCKS = 132


def tile_cols(M: int, N: int) -> int:
    """Output columns a GEMM block: the widest of ``TILE_COLS`` whose grid
    has ``MIN_BLOCKS`` blocks, else the narrowest."""
    for c in TILE_COLS:
        if math.prod(bfp_grid(M, N, c)) >= MIN_BLOCKS:
            return c
    return TILE_COLS[-1]


def bfp_grid(M: int, N: int, cols: int | None = None) -> tuple:
    """The GEMM's grid: (column tiles, 8-row tiles)."""
    cols = tile_cols(M, N) if cols is None else cols
    return (-(-N // cols), -(-M // TILE_ROWS))


def scratch_shapes(M: int, K: int, block: int) -> tuple:
    """The pre-pass's outputs, int32: x's mantissa words (ceil(M / 8),
    K / 4, 8), 4 k a word and the 8 rows of a tile side by side, and the
    exponents (ceil(M / 8), K / block, 8)."""
    mt = -(-M // TILE_ROWS)
    return (mt, K // 4, TILE_ROWS), (mt, K // block, TILE_ROWS)


def quantize_weights(w, *, block: int = 32):
    """(K, N) weights -> (wq (K/G, N, G) mantissas, we (KB, N) int8
    exponents), quantized per K-block along K as the reference's
    ``quantize_weights`` does; plain tensor code, done once per layer."""
    m, e, _ = bfp.quantize(w, block=block, bits=BITS, axis=0)  # (KB,blk,N)
    K, N = w.shape
    g = math.gcd(block, 4)
    wq = m.reshape(K // g, g, N).permute(0, 2, 1).contiguous()
    return wq, e


def reference_layout(wq, block: int):
    """The reference's (KB, block, N) mantissas of a staged ``wq``."""
    kg, N, g = wq.shape
    return wq.permute(0, 2, 1).reshape(kg * g // block, block, N)


def _quantize_rows(x, block: int):
    """Activation quantization exactly as the kernel does it: (mantissas
    (M, KB, block) f32 of integer values, exponents (M, KB) int32, and the
    (M, KB) mask of blocks holding a NaN or an infinity)."""
    M, K = x.shape
    xb = x.reshape(M, K // block, block)
    bad = ~torch.isfinite(xb).all(dim=-1)
    amax = xb.abs().amax(dim=-1)
    pos = (amax > 0) & ~bad
    _, e = torch.frexp(torch.where(pos, amax, torch.ones_like(amax)))
    e = torch.where(pos, e, torch.zeros_like(e))
    qmax = float(2 ** (BITS - 1) - 1)
    v = torch.round(xb * bfp.pow2((BITS - 1) - e)[..., None])
    # fmin/fmax as the kernel's fminf/fmaxf: a NaN product clips to qmax
    q = torch.fmax(torch.fmin(v, v.new_tensor(qmax)), v.new_tensor(-qmax))
    return q, e, bad


def quantize_activations(x, block: int):
    """The pre-pass's bytes in plain PyTorch: (words, exponents) in the
    layouts of :func:`scratch_shapes`, from :func:`_quantize_rows`; the rows
    past M are zero, a non-finite K-block's exponent is ``BAD_EXPONENT``.
    Each word holds 4 consecutive k of one row, byte i = k offset i."""
    M, K = x.shape
    q, e, bad = _quantize_rows(x.to(torch.float32), block)
    (mt, kw, rows), _ = scratch_shapes(M, K, block)
    pad = mt * rows - M
    bytes_ = torch.nn.functional.pad(q.reshape(M, K).to(torch.int8),
                                     (0, 0, 0, pad))
    words = bytes_.view(torch.int32).reshape(mt, rows, kw).transpose(1, 2)
    ex = torch.where(bad, BAD_EXPONENT, e.to(torch.int32))
    ex = torch.nn.functional.pad(ex, (0, 0, 0, pad))
    ex = ex.reshape(mt, rows, K // block).transpose(1, 2)
    return words.contiguous(), ex.contiguous()


def bfp_matmul_plain(x, wq, we, *, block: int):
    """The kernel's function in plain PyTorch, from its exact arguments.

    Each K-block's mantissa dot is taken exactly (float64 holds every such
    sum of integers exactly, with no TF32 on the card), scaled by an exact
    power of two, and the K-blocks are summed in ascending order in f32 with
    separate multiply and add, as the kernel does — so the two agree bit
    for bit."""
    x = x.to(torch.float32)
    M, K = x.shape
    wm = reference_layout(wq, block)                        # (KB, blk, N)
    q, ex, bad = _quantize_rows(x, block)
    dots = torch.einsum("mkb,kbn->mkn", q.double(),
                        wm.double()).to(torch.float32)      # (M, KB, N)
    scale = bfp.pow2(ex[:, :, None] + we.to(torch.int32)[None]
                     - 2 * (BITS - 1))
    prods = torch.where(bad[:, :, None], float("nan"), dots * scale)
    acc = torch.zeros((M, wm.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for kb in range(K // block):
        acc = acc + prods[:, kb]
    return acc


def _check_cuda_args(x, wq, we, block: int):
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"bfp_matmul: the kernel takes blocks "
                         f"{KERNEL_BLOCKS}; got block={block}")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"bfp_matmul: x must be one of {list(X_DTYPES)}; "
                         f"got {x.dtype}")
    for t, dtype in ((x, x.dtype), (wq, torch.int8), (we, torch.int8)):
        if t.device != x.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"bfp_matmul: expected a contiguous {dtype} "
                             f"tensor on {x.device}; got {t.dtype} on "
                             f"{t.device}, contiguous={t.is_contiguous()}")
    if wq.shape[-1] != 4:
        raise ValueError(f"bfp_matmul: weight stream layout {tuple(wq.shape)}"
                         " is not (K/4, N, 4)")
    if wq.data_ptr() % 16 or we.data_ptr() % 16:
        raise ValueError("bfp_matmul: the weight stream and its exponents "
                         "must be 16-byte aligned")


def _bfp_matmul_cuda(x, wq, we, *, block: int):
    """-> (out, scratch): the scratch holds the pre-pass's words, then its
    exponents (:func:`scratch_shapes`)."""
    global launches
    _check_cuda_args(x, wq, we, block)
    if x.data_ptr() % 16:           # the kernel reads x 4 values at a time
        x = x.clone()
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), device=x.device, dtype=torch.float32)
    words, exps = scratch_shapes(M, K, block)
    scratch = torch.empty(math.prod(words) + math.prod(exps),
                          device=x.device, dtype=torch.int32)
    err = build.library().lib.repro_bfp_matmul(
        x.data_ptr(), wq.data_ptr(), we.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), M, K, N, block, tile_cols(M, N), X_DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bfp_matmul")
    launches += 1
    return out, scratch


def bfp_matmul(x, wq, we, *, block: int = 32):
    """x (M, K) f32 or bf16; ``wq``/``we`` from :func:`quantize_weights`
    with the same ``block``.  -> (M, N) f32."""
    M, K = x.shape
    kg, N, g = wq.shape
    if kg * g != K or K % block or tuple(we.shape) != (K // block, N):
        raise ValueError(f"bfp_matmul: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, we {tuple(we.shape)} do not "
                         f"fit block {block}")
    if x.device.type == "cpu":
        return bfp_matmul_plain(x, wq, we, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"bfp_matmul: unsupported device {x.device}")
    if M == 0 or N == 0:
        return torch.zeros((M, N), device=x.device, dtype=torch.float32)
    return _bfp_matmul_cuda(x.contiguous(), wq, we, block=block)[0]
