"""Kernel 1's bf16 tensor-core route modelled on the CPU.

With bf16 x and a bf16 slab, the direct conv kernel runs its implicit
GEMM as bf16 ``mma.sync.m16n8k16`` products with f32 accumulators
(``csrc/conv_direct_bf16.cu``): each mma takes 16 consecutive reduction
indices (di, dj, c), c fastest, from a multiple of 16, the ragged tail
zero-filled, and the k-steps run in ascending order into one accumulator
an output.  This file builds that arithmetic from the plain version's own
pieces (``conv2d_direct_plain``'s padded taps and unpacked slab, the
bias, ReLU and ``apply_epilogue``) and checks:

- every bf16 x bf16 product is exact in f32;
- two models of a k-step's accumulation, each within one bf16 step
  (|d| <= 2^-7 |ref| + 1e-5 max|ref|) of the reference's interpret-mode
  ``_direct_kernel`` on bf16 x: the k-step's 16 products and the
  accumulator summed exactly and rounded once to f32, and a truncating
  one (the 17 terms aligned to the largest exponent, each cut toward zero
  to 24 significant bits, summed exactly, the sum cut toward zero to
  f32), which is how the tensor cores' f32 accumulation loses bits;
- against the FFMA route on the widened inputs (one fmaf chain an output,
  modelled exactly), no output more than one bf16 step apart (a ReLU
  output near zero may round from f32 noise: the 1e-5 max|ref| floor);
  the share one bf16 step apart is printed (``-s``);
- ``chip_smoke.py``'s measure of that rule on the card (``steps_apart``)
  counts one bf16 step as within it and two as not.

Layers: the direct layers of ``tests/test_torch_bf16.py::LAYERS`` (reduced
conv1 and conv2) and full-width conv2 at batch 1.  Inputs are made with
numpy from a seed; both packages get the same values.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)
from test_torch_bf16 import LAYERS  # noqa: E402

from repro.kernels.conv import direct as j_direct  # noqa: E402
from repro.nn.pooling import LrnParams as JLrn  # noqa: E402
from repro_torch.kernels.conv import direct, dma  # noqa: E402
from repro_torch.kernels.conv.epilogue import \
    grouped_channel_pad  # noqa: E402
from repro_torch.nn.pooling import LrnParams, apply_epilogue  # noqa: E402

BF16_STEP = 2.0 ** -7
KSTEP = 16
# (name, kw, r, B, H, c_in, c_out): the reduced direct layers and
# full-width conv2 at batch 1
CASES = ([(name, kw, r, B, H, ci, co)
          for name, kind, kw, r, B, H, ci, co in LAYERS if kind == "direct"]
         + [("conv2_full_b1", dict(groups=2, lrn=True, pool=(3, 2)), 5, 1,
             27, 96, 256)])


def _inputs(seed, B, H, c_in, c_out, r, groups):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((r, r, c_in // groups, c_out))
         * (r * r * c_in / groups) ** -0.5).astype(np.float32)
    b = (rng.standard_normal((c_out,)) * 0.1).astype(np.float32)
    return x, w, b


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def gemm_operands(x, w_tiles, p):
    """Per group, the implicit GEMM's A (M, R) and B (R, K) as f32 numpy,
    the reduction over (di, dj, c), c < C fastest, as the kernel walks it:
    A from the plain version's padded taps, B from its unpacked slab."""
    wg = dma.unpack_weight_tiles(w_tiles, p.weights).float()
    xg, _ = grouped_channel_pad(x.float(), p.g, p.Cb)
    B, H, W, _ = x.shape
    s, r = p.s, p.r
    hi_h = max(s * (p.out_h - 1) + r - H - p.ph_lo, 0)
    hi_w = max(s * (p.out_w - 1) + r - W - p.pw_lo, 0)
    xp = F.pad(xg, (0, 0, p.pw_lo, hi_w, p.ph_lo, hi_h))
    out = []
    for gi in range(p.g):
        xs = xp[..., gi * p.Cp:gi * p.Cp + p.C]
        taps = [xs[:, di:di + s * (p.out_h - 1) + 1:s,
                   dj:dj + s * (p.out_w - 1) + 1:s]
                for di in range(r) for dj in range(r)]
        a = torch.stack(taps, dim=3).reshape(-1, r * r * p.C)
        b = wg[gi, :, :, :p.C, :p.K].reshape(r * r * p.C, p.K)
        out.append((a.numpy(), b.numpy()))
    return out


def _cut_to_f32(v):
    """f64 -> f32 rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def mma_sums(a, b, model):
    """The tensor-core route's f32 sums (M, K): k-steps of 16 in order,
    the ragged tail zero-filled, each k-step's 16 exact products and the
    accumulator summed under ``model``: "round" (exactly, rounded once to
    f32) or "truncate" (aligned to the largest exponent, each term and
    the sum cut toward zero to 24 significant bits / f32).  Asserts that
    every product is exact in f32."""
    R = a.shape[1]
    pad = -R % KSTEP
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, R + pad, KSTEP):
        a32, b32 = a[:, k0:k0 + KSTEP, None], b[None, k0:k0 + KSTEP]
        prod = a32.astype(np.float64) * b32.astype(np.float64)
        assert np.array_equal(prod, (a32 * b32).astype(np.float64))
        if model == "round":
            acc = (acc.astype(np.float64) + prod.sum(axis=1)).astype(
                np.float32)
            continue
        terms = np.concatenate([acc[:, None].astype(np.float64), prod], 1)
        _, e = np.frexp(np.abs(terms).max(axis=1, keepdims=True))
        q = np.ldexp(1.0, e - 24)
        acc = _cut_to_f32((np.trunc(terms / q) * q).sum(axis=1))
    return acc


def ffma_sums(a, b):
    """The FFMA route's f32 sums on the widened inputs: one fmaf chain an
    output from +0 over the reduction in order (exact product, one
    rounding a step)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for k in range(a.shape[1]):
        acc = (acc + a64[:, k, None] * b64[None, k]).astype(np.float32)
    return acc


def layer_out(sums, bias, p, B, lrn, pool):
    """Per-group sums -> the layer's bf16 output, as the kernel finishes
    it: bias and ReLU on the f32 map, the LRN and pool, one rounding."""
    y = torch.from_numpy(np.concatenate(sums, axis=-1)).reshape(
        B, p.out_h, p.out_w, p.Kfull)
    y = torch.clamp_min(y + bias.float(), 0.0)
    return apply_epilogue(y, lrn, pool).to(torch.bfloat16).float().numpy()


def excess(got, ref):
    return float((np.abs(got - ref) - BF16_STEP * np.abs(ref)
                  - 1e-5 * np.abs(ref).max()).max())


def bf16_step(v):
    """One bf16 step at |v| (0 at 0)."""
    mag = np.abs(v).astype(np.float64)
    _, e = np.frexp(np.where(mag > 0, mag, 1.0))
    return np.where(mag > 0, np.ldexp(1.0, e - 8), 0.0)


@pytest.mark.parametrize("name,kw,r,B,H,c_in,c_out", CASES,
                         ids=[c[0] for c in CASES])
def test_mma_route_model_within_one_bf16_step(name, kw, r, B, H, c_in,
                                              c_out):
    x, w, b = _inputs(11, B, H, c_in, c_out, r, kw.get("groups", 1))
    kwp = {k: v for k, v in kw.items() if k != "lrn"}
    lrn = LrnParams() if kw.get("lrn") else None
    ref = np.asarray(j_direct.conv2d_direct(
        *(jnp.asarray(v).astype(jnp.bfloat16) for v in (x, w, b)),
        relu=True, interpret=True, lrn=JLrn() if lrn else None,
        **kwp).astype(jnp.float32))
    xb, wb, bb = _bf16(x), _bf16(w), _bf16(b)
    p = direct.plan(tuple(xb.shape), tuple(wb.shape), **kwp)
    ops = gemm_operands(xb, direct.pack_weights(wb, p), p)
    pool = kw.get("pool")
    outs = {model: layer_out([mma_sums(a, bm, model) for a, bm in ops],
                             bb, p, B, lrn, pool)
            for model in ("round", "truncate")}
    ffma = layer_out([ffma_sums(a, bm) for a, bm in ops], bb, p, B, lrn,
                     pool)
    plain = direct.conv2d_direct_plain(xb, direct.pack_weights(wb, p), bb,
                                       p, relu=True, lrn=lrn, pool=pool)
    # the FFMA model is the plain version's function: within f32 noise
    assert excess(ffma, plain.float().numpy()) <= 0
    floor = 1e-5 * np.abs(ffma).max()
    for model, got in outs.items():
        assert got.shape == ref.shape
        assert excess(got, ref) <= 0, (model, excess(got, ref))
        apart = np.abs(got - ffma)
        step = np.maximum(bf16_step(got), bf16_step(ffma))
        assert (apart <= step + floor).all(), (model, float(
            (apart - step).max()))
        print(f"{name} {model}: {float((got != ffma).mean()):.3e} of "
              f"{got.size} outputs one bf16 step off the FFMA route; "
              f"excess vs the reference {excess(got, ref):.3e}")


def test_card_measure_of_one_bf16_step():
    """``chip_smoke.steps_apart``, which phase 3b holds the card's route
    to: outputs one bf16 step apart (at the larger magnitude) pass, two
    steps fail, a ReLU output rounding from f32 noise near zero passes."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_rule", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = torch.tensor([1.0, -3.0, 0.5, 0.0, 96.0], dtype=torch.bfloat16)
    bits = want.view(torch.int16)
    one = (bits + torch.tensor([1, 1, -1, 0, 0], dtype=torch.int16)).view(
        torch.bfloat16)
    two = (bits + torch.tensor([0, 2, 0, 0, 0], dtype=torch.int16)).view(
        torch.bfloat16)
    noise = torch.tensor([1.0, -3.0, 0.5, 1e-5, 96.0], dtype=torch.bfloat16)
    assert smoke.steps_apart(torch, one, want) <= 0
    assert smoke.steps_apart(torch, two, want) > 0
    assert smoke.steps_apart(torch, noise, want) <= 0
    assert smoke.steps_apart(torch, want, want) < 0
