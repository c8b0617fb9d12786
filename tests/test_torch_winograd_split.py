"""A split-bf16 tensor-core design of kernels 2-3 modelled on the CPU.

Kernels 2-3 run their Winograd-domain products on the CUDA cores in f32,
in bf16 models too (``csrc/conv_winograd.cu``).  Running them on the
bf16 tensor cores instead needs each f32 operand (U = B^T d B and the
slab G w G^T, neither a bf16 value) split into bf16 parts: hi = rn(v),
mid = rn(v - hi), lo = rn(v - hi - mid), and each product summed from
the parts' products (with three parts: hi.hi, hi.mid, mid.hi, hi.lo,
mid.mid, lo.hi).  This file models that arithmetic with exact f32 sums,
built from the plain version's stages (``conv2d_winograd_plain``: the
padded tiles, B^T d B, the unpacked slab, A^T M A, bias, ReLU, the
epilogue), and checks:

- the split: two parts reproduce an f32 value within 2^-16 relative, three
  within 2^-24;
- the three-part products within one bf16 step (|d| <= 2^-7 |ref| + 1e-5
  max|ref|) of the reference's interpret-mode ``_conv2d_kernel`` and
  ``_conv2d_fused_kernel`` on bf16 x, and of the port's plain version, at
  reduced AlexNet conv3-conv5 at m = 2, 4, 6 and three VGG-16 geometries
  (56^2 x 128 -> 256, 28^2 x 256 -> 512, 14^2 x 512 -> 512 pooled) at
  m = 4;
- a split in two with three products (2^-16 a product) is not within one
  bf16 step at three VGG-16 geometries over five seeds: the channel sums
  cancel and A^T M A magnifies the rest, so such a design needs three
  parts;
- a non-finite input stays non-finite (Inf - Inf = NaN in the split).

The model sums exactly; the tensor cores' f32 accumulation truncates,
which the model does not capture (ROADMAP Queue 2 says what that cost a
kernel built on this design).  Inputs are made with numpy from a seed;
both packages get the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro.kernels.conv import winograd as j_winograd  # noqa: E402
from repro_torch.core.winograd import tiles_2d, \
    transform_tensors  # noqa: E402
from repro_torch.kernels.conv import dma, winograd  # noqa: E402
from repro_torch.kernels.conv.epilogue import \
    grouped_channel_pad  # noqa: E402
from repro_torch.nn.pooling import apply_epilogue  # noqa: E402

BF16_STEP = 2.0 ** -7
# (U part, V part) of the products the design sums, in its order: three
# parts and, for the comparison, two
PRODUCTS = {3: ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)),
            2: ((0, 0), (0, 1), (1, 0))}

# (name, kw, m, B, H, c_in, c_out): reduced AlexNet conv3-conv5 at m = 2,
# 4, 6, and VGG-16 geometries at its served m = 4
ALEX = [("conv3", dict(), 2, 13, 32, 48),
        ("conv4", dict(groups=2), 2, 13, 48, 48),
        ("conv5", dict(groups=2, pool=(3, 2)), 2, 13, 48, 32)]
CASES = ([(name, kw, m, *rest) for name, kw, *rest in ALEX
          for m in (2, 4, 6)]
         + [("vgg56_128_256", dict(), 4, 1, 56, 128, 256),
            ("vgg28_256_512", dict(), 4, 1, 28, 256, 512),
            ("vgg14_512_512_pool", dict(pool=(2, 2)), 4, 2, 14, 512, 512)])


def _inputs(seed, B, H, c_in, c_out, groups):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c_in // groups, c_out))
         * (9 * c_in / groups) ** -0.5).astype(np.float32)
    b = (rng.standard_normal((c_out,)) * 0.1).astype(np.float32)
    return x, w, b


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def split_parts(v, parts):
    """f32 ``v`` -> ``parts`` bf16 values (held in f32) summing to about
    ``v``: each the rest rounded to bf16 (nearest even); the rests are
    exact in f32."""
    out, rest = [], v
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def split_route(x, w_tiles, bias, p, *, lrn, pool, parts=3):
    """The split design's function in plain PyTorch: the plain version's
    stages, each Winograd-domain product summed from ``parts``-way split
    operands in the design's order, in f32; the output rounded once to
    x's dtype."""
    V = dma.unpack_weight_tiles(w_tiles, p.weights).float()
    xg, _ = grouped_channel_pad(x.float(), p.g, p.Cb)
    B, H, W, _ = x.shape
    mm, r = p.m, p.r
    th = -(-p.out_h // mm)
    need_h, need_w = th * mm + r - 1, p.tw * mm + r - 1
    xp = F.pad(xg, (0, 0, p.ph_pad, need_w - W - p.ph_pad,
                    p.ph_pad, need_h - H - p.ph_pad))
    BT, _, AT = transform_tensors(mm, r, x.device)
    U = torch.einsum("in,bhwnmc,jm->bhwijc", BT, tiles_2d(xp, mm, p.n), BT)
    us, vs = split_parts(U, parts), split_parts(V, parts)
    ys = []
    for gi in range(p.g):
        chans = slice(gi * p.Cp, (gi + 1) * p.Cp)
        M = 0
        for a, c in PRODUCTS[parts]:
            M = M + torch.einsum("bhwijc,ijck->bhwijk", us[a][..., chans],
                                 vs[c][gi, ..., :p.K])
        Y = torch.einsum("pi,bhwijk,qj->bhwpqk", AT, M, AT)
        Y = Y.permute(0, 1, 3, 2, 4, 5).reshape(B, th * mm, p.tw * mm, p.K)
        ys.append(Y[:, :p.out_h, :p.out_w])
    y = torch.clamp_min(torch.cat(ys, dim=-1) + bias.float(), 0.0)
    return apply_epilogue(y, lrn, pool).to(x.dtype)


def excess(got, ref):
    """max(|got - ref| - (one bf16 step of |ref| + 1e-5 max|ref|)): <= 0
    within one bf16 step."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref.float() if isinstance(ref, torch.Tensor) else ref,
                     np.float32)
    assert got.shape == ref.shape
    return float((np.abs(got - ref) - BF16_STEP * np.abs(ref)
                  - 1e-5 * np.abs(ref).max()).max())


def _layer(seed, kw, m, B, H, c_in, c_out):
    """(x, w, b as bf16, plan, f32 slab, plain version's output)."""
    x, w, b = (_bf16(a) for a in _inputs(seed, B, H, c_in, c_out,
                                          kw.get("groups", 1)))
    p = winograd.plan(tuple(x.shape), tuple(w.shape), m=m, **kw)
    slab = winograd.pack_weights(w, p)
    plain = winograd.conv2d_winograd_plain(x, slab, b, p, relu=True,
                                           lrn=None, pool=kw.get("pool"))
    return x, w, b, p, slab, plain


@pytest.mark.parametrize("parts,bits", [(2, 16), (3, 24)])
def test_split_parts_reproduce_the_operand(parts, bits):
    """Winograd-domain values over 2^-40 .. 2^40: the parts' sum within
    2^-bits of each value; each part is a bf16 value."""
    rng = np.random.default_rng(parts)
    v = torch.from_numpy((rng.standard_normal(20000)
                          * 2.0 ** rng.integers(-40, 40, 20000)
                          ).astype(np.float32))
    ps = split_parts(v, parts)
    for q in ps:
        assert torch.equal(q.to(torch.bfloat16).float(), q)
    rel = ((sum(ps) - v).abs() / v.abs()).max()
    assert rel <= 2.0 ** -bits, float(rel)


@pytest.mark.parametrize("name,kw,m,B,H,c_in,c_out", CASES,
                         ids=[f"{c[0]}_m{c[2]}" for c in CASES])
def test_split_route_within_one_bf16_step_of_jax(name, kw, m, B, H, c_in,
                                                 c_out):
    """The modelled design on bf16 x within one bf16 step of the
    reference's interpret-mode kernel and of the plain version."""
    x, w, b, p, slab, plain = _layer(1, kw, m, B, H, c_in, c_out)
    ref = j_winograd.conv2d_winograd(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (x, w, b)), m=m, relu=True, interpret=True, **kw)
    got = split_route(x, slab, b, p, lrn=None, pool=kw.get("pool"))
    assert got.dtype is torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert excess(got, np.asarray(ref.astype(jnp.float32))) <= 0
    assert excess(got, plain) <= 0


# VGG-16 geometries (batch 1-2) at which two-part operands are held to
# one bf16 step, over SPLIT_SEEDS
SPLIT_GEOMETRIES = [("vgg56_128_256", dict(), 1, 56, 128, 256),
                    ("vgg28_256_512", dict(), 1, 28, 256, 512),
                    ("vgg14_512_512_pool", dict(pool=(2, 2)), 2, 14, 512,
                     512)]
SPLIT_SEEDS = (1, 2, 3, 4, 5)


@pytest.mark.parametrize("seed", SPLIT_SEEDS)
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out", SPLIT_GEOMETRIES,
                         ids=[g[0] for g in SPLIT_GEOMETRIES])
def test_two_part_split_is_not_within_one_bf16_step(name, kw, B, H, c_in,
                                                    c_out, seed,
                                                    record_property):
    """Three products of two-part operands (2^-16 each) leave every seed's
    VGG-16 layer more than one bf16 step off the plain version near zero,
    while six products of three-part operands stay within it: the design
    splits in three.  Each excess is recorded (and printed) as
    a share of max|ref|; the step's floor is 1e-5 of it."""
    x, _, b, p, slab, plain = _layer(seed, kw, 4, B, H, c_in, c_out)
    scale = float(plain.float().abs().max())
    two, three = (excess(split_route(x, slab, b, p, lrn=None,
                                     pool=kw.get("pool"), parts=parts),
                         plain) / scale for parts in (2, 3))
    record_property("excess_two_part", float(two))
    record_property("excess_three_part", float(three))
    print(f"{name} seed {seed}: excess of max|ref|, two-part {two:+.3e}, "
          f"three-part {three:+.3e}")
    assert two > 0 and three <= 0


@pytest.mark.parametrize("value", [np.inf, np.nan])
def test_split_route_keeps_non_finite_visible(value):
    """Where the plain version's output is non-finite, the modelled
    design's is too (a split Inf gives NaN parts)."""
    x, w, b, p, slab, _ = _layer(2, dict(pool=(3, 2)), 4, 2, 13, 16, 24)
    x = x.clone()
    x[1, 5, 6, 3] = value
    plain = winograd.conv2d_winograd_plain(x, slab, b, p, relu=True,
                                           lrn=None, pool=(3, 2))
    got = split_route(x, slab, b, p, lrn=None, pool=(3, 2))
    bad = ~torch.isfinite(plain.float())
    assert bad.any() and not torch.isfinite(got.float()[bad]).any()
    assert torch.isfinite(got.float()[~bad]).all()
