"""The port's CUDA conv kernels against their plain PyTorch versions.

Marked ``cuda``: they need the card and skip without one.  Each case runs
the kernel wrapper on a CUDA tensor and the same wrapper on a CPU tensor
(which takes the plain version), on numpy-made inputs, across the AlexNet
geometries (reduced and full width) and off-AlexNet blockings: several
channel blocks with channel padding, several K blocks, strides, VALID /
SAME, groups, LRN without pool, pool without LRN.  Tolerance: max|diff| <=
1e-4 * max(1, max|plain|) — both sides FP32, summed in different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv import direct, ops, winograd  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.nn.pooling import LrnParams  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 ImageRequest)

LRN = LrnParams()
POOL = (3, 2)

# (name, kw, B, H, c_in, c_out)
DIRECT_CASES = [
    ("conv1_reduced", dict(stride=4, padding="VALID", lrn=LRN, pool=POOL),
     11, 2, 35, 3, 16),
    ("conv2_reduced", dict(groups=2, lrn=LRN, pool=POOL), 5, 2, 13, 16, 32),
    ("conv1_full", dict(stride=4, padding="VALID", lrn=LRN, pool=POOL),
     11, 8, 227, 3, 96),
    ("conv2_full", dict(groups=2, lrn=LRN, pool=POOL), 5, 8, 27, 96, 256),
    ("s2_same_plain", dict(stride=2), 3, 2, 9, 5, 7),
    ("cblocks_pool2", dict(pool=(2, 2), c_block=2), 1, 2, 8, 5, 40),
    ("kblocks_lrn_g2", dict(groups=2, lrn=LRN, k_block=4), 3, 2, 7, 6, 16),
]

WINO_CASES = [
    ("conv3_reduced", dict(), 2, 13, 32, 48),
    ("conv4_reduced", dict(groups=2), 2, 13, 48, 48),
    ("conv5_reduced", dict(groups=2, pool=POOL), 2, 13, 48, 32),
    ("conv3_full", dict(), 8, 13, 256, 384),
    ("conv4_full", dict(groups=2), 8, 13, 384, 384),
    ("conv5_full", dict(groups=2, pool=POOL), 8, 13, 384, 256),
    ("valid_kpad", dict(padding="VALID", k_block=32), 2, 11, 8, 40),
    ("lrn_only_cblocks", dict(lrn=LRN, c_block=4), 2, 10, 12, 8),
    ("lrn_pool_kblocks_g2", dict(groups=2, lrn=LRN, pool=POOL, k_block=4),
     2, 17, 24, 16),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _inputs(seed, B, H, c_in, c_out, r, groups):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, c_in)).astype(np.float32)
    w = (rng.standard_normal((r, r, c_in // groups, c_out))
         * (r * r * c_in / groups) ** -0.5).astype(np.float32)
    b = rng.standard_normal((c_out,)).astype(np.float32) * 0.1
    return x, w, b


def _both(fn, card, x, w, b):
    got = fn(*(torch.from_numpy(a).to(card) for a in (x, w, b)))
    torch.cuda.synchronize()
    ref = fn(*(torch.from_numpy(a) for a in (x, w, b)))
    return got.cpu().numpy(), ref.numpy()


def _close(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,r,B,H,c_in,c_out", DIRECT_CASES)
def test_direct_kernel_matches_plain(card, name, kw, r, B, H, c_in, c_out):
    x, w, b = _inputs(0, B, H, c_in, c_out, r, kw.get("groups", 1))
    n0 = direct.launches
    got, ref = _both(lambda x, w, b: direct.conv2d_direct(
        x, w, b, relu=True, **kw), card, x, w, b)
    assert direct.launches == n0 + 1
    _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,B,H,c_in,c_out", WINO_CASES)
def test_winograd_kernels_match_plain(card, name, kw, B, H, c_in, c_out):
    x, w, b = _inputs(1, B, H, c_in, c_out, 3, kw.get("groups", 1))
    before = ops.launch_counts()
    got, ref = _both(lambda x, w, b: winograd.conv2d_winograd(
        x, w, b, relu=True, **kw), card, x, w, b)
    key = ("conv_winograd_fused" if "lrn" in kw or "pool" in kw
           else "conv_winograd")
    assert ops.launch_counts()[key] == before[key] + 1
    _close(got, ref)


@pytest.mark.cuda
def test_nan_input_stays_visible(card):
    """A poisoned image must reach the logits screen as NaN: ReLU and the
    pool keep NaN on the kernel path, as they do in the plain version."""
    x, w, b = _inputs(2, 1, 35, 3, 16, 11, 1)
    x[0, 10, 10, 0] = np.nan
    got, ref = _both(lambda x, w, b: direct.conv2d_direct(
        x, w, b, stride=4, padding="VALID", relu=True, lrn=LRN, pool=POOL),
        card, x, w, b)
    assert np.array_equal(np.isnan(got), np.isnan(ref)) and np.isnan(got).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["direct", "winograd", "winograd_fused"])
def test_kernel_blocking_is_bit_equal(card, kind):
    """The slab's channel and K blocking changes only addressing: each
    kernel sums the real channels in one fixed order, so any blocking
    gives the default's bits."""
    if kind == "direct":
        x, w, b = _inputs(3, 2, 27, 96, 256, 5, 2)
        fn = direct.conv2d_direct
        kw = dict(groups=2, lrn=LRN, pool=POOL)
    else:
        x, w, b = _inputs(4, 2, 13, 384, 256, 3, 2)
        fn = winograd.conv2d_winograd
        kw = dict(groups=2, pool=POOL if kind == "winograd_fused" else None)
    x, w, b = (torch.from_numpy(a).to(card) for a in (x, w, b))
    base = fn(x, w, b, relu=True, **kw)
    other = fn(x, w, b, relu=True, c_block=40, k_block=32, **kw)
    torch.cuda.synchronize()
    assert torch.equal(base, other)


class _FailingLib:
    """Stands in for the loaded kernel library: every launcher reports
    ``cudaErrorLaunchFailure`` (719)."""
    def __getattr__(self, name):
        return lambda *args: 719


@pytest.mark.cuda
def test_kernel_launch_error_raises_and_never_degrades(card, monkeypatch):
    """A kernel launch that fails on the card raises out of the engine; the
    bucket is not moved onto the ``direct`` route's library convolutions."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(), use_pallas=True)
    real = build.library()
    monkeypatch.setattr(build, "library", lambda: dataclasses.replace(
        real, lib=_FailingLib()))
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=2, degrade_threshold=1),
                    params=alexnet.init(0, cfg, device=card), device=card)
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.submit(ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels))
            .astype(np.float32)))
    with pytest.raises(build.KernelError, match="cudaError_t 719"):
        eng.run_until_done()
    s = eng.stats()
    assert s["degradations"] == [] and s["batches_failed"] == 0


@pytest.mark.cuda
def test_engine_builds_the_kernels_up_front(card, monkeypatch):
    """On the card, route ``pallas`` builds the kernels when the engine is
    made, so a kernel that cannot build fails there."""
    cfg = dataclasses.replace(get_config("alexnet").reduced(), use_pallas=True)
    params = alexnet.init(0, cfg, device=card)

    def broken():
        raise build.KernelError("nvcc failed for ['conv_direct.cu']")

    monkeypatch.setattr(build, "library", broken)
    with pytest.raises(build.KernelError, match="nvcc failed"):
        CnnEngine(cfg, CnnServeConfig(), params=params, device=card)
