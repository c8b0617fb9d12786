"""Packed weight slabs shared by the conv kernels, and cross-layer staging.

Tile order contract (the reference's ``kernels/conv/dma.py``): the packed
slab is ``(n_tiles, *spatial, Cb, Kb)`` with tile ``lin = k * ncb + c`` for
group-major K blocks ``k in [0, g*nkb)`` and C blocks ``c in [0, ncb)``.
The CUDA kernels index this layout directly.  The reference's in-kernel
double-buffered DMA stream has no counterpart here: a GPU block reads its
weights through L2/L1 (see the kernels' source notes).

ABFT (the reference's SDC defense): an armed slab carries one extra ``Cb``
row in every tile, the bit-pattern column checksum of the rows above it
(:func:`append_checksum_row`).  The armed CUDA kernels check the whole
slab they read, every lane once a launch (``csrc/abft.cuh``), and add the
count of mismatched lanes to an int32 verdict; :func:`checksum_mismatches`
is that count in plain PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class WeightPlan:
    """Blocking of one layer's weight slab into tiles.

    ``spatial`` is the per-tile filter extent — ``(n, n)`` Winograd-domain
    or ``(r, r)`` direct.  ``checksum`` arms ABFT: every tile carries one
    extra ``Cb`` row, its checksum, so ``tile_shape`` grows to
    ``(*spatial, Cb + 1, Kb)``.
    """
    g: int                  # groups
    nkb: int                # K blocks per group
    ncb: int                # C blocks
    Cb: int                 # channel block
    Kb: int                 # output-channel block
    spatial: tuple          # per-tile filter dims
    checksum: bool = False  # ABFT checksum row appended to every tile

    @property
    def n_tiles(self) -> int:
        return self.g * self.nkb * self.ncb

    @property
    def tap_rows(self) -> int:
        """Slab rows a filter tap: ``Cb``, or ``Cb + 1`` when armed."""
        return self.Cb + (1 if self.checksum else 0)

    @property
    def tile_shape(self) -> tuple:
        return (*self.spatial, self.tap_rows, self.Kb)


def pack_weight_tiles(wg, plan: WeightPlan):
    """(g, *spatial, ncb*Cb, nkb*Kb) blocked weights -> (n_tiles, *tile)."""
    g, ncb, Cb, nkb, Kb = plan.g, plan.ncb, plan.Cb, plan.nkb, plan.Kb
    ns = len(plan.spatial)
    assert tuple(wg.shape) == (g, *plan.spatial, ncb * Cb, nkb * Kb), (
        tuple(wg.shape), plan)
    w7 = wg.reshape(g, *plan.spatial, ncb, Cb, nkb, Kb)
    # (g, *spatial, ncb, Cb, nkb, Kb) -> (g, nkb, ncb, *spatial, Cb, Kb)
    perm = (0, ns + 3, ns + 1, *range(1, ns + 1), ns + 2, ns + 4)
    tiles = w7.permute(perm).reshape(plan.n_tiles, *plan.spatial, Cb,
                                     Kb).contiguous()
    return append_checksum_row(tiles) if plan.checksum else tiles


def unpack_weight_tiles(tiles, plan: WeightPlan):
    """Inverse of :func:`pack_weight_tiles` (an armed slab loses its
    checksum rows): (n_tiles, *tile) -> (g, *spatial, ncb*Cb, nkb*Kb)."""
    g, ncb, Cb, nkb, Kb = plan.g, plan.ncb, plan.Cb, plan.nkb, plan.Kb
    ns = len(plan.spatial)
    if plan.checksum:
        tiles = tiles[..., :-1, :]
    t7 = tiles.reshape(g, nkb, ncb, *plan.spatial, Cb, Kb)
    # (g, nkb, ncb, *spatial, Cb, Kb) -> (g, *spatial, ncb, Cb, nkb, Kb)
    perm = (0, *range(3, 3 + ns), 2, 3 + ns, 1, 4 + ns)
    return t7.permute(perm).reshape(g, *plan.spatial, ncb * Cb, nkb * Kb)


# ---------------------------------------------------------------------------
# ABFT tile checksums
# ---------------------------------------------------------------------------
# The checksum is taken over the tile's bit patterns, not its values: each
# lane is bitcast to the same-width integer and the column is summed with
# wraparound (mod 2**width) along the Cb axis.  A single flipped bit
# anywhere — a weight row, a zero padding row or the checksum row — moves
# the sum by +-2**k mod 2**width, never 0, and a clean slab never
# mismatches (integer addition is exact and order-free).  The bitcasts are
# ``Tensor.view(int dtype)`` on contiguous tensors, never float arithmetic,
# so NaN payloads survive.
_CHECKSUM_INT = {4: torch.int32, 2: torch.int16}


def checksum_int_dtype(dtype):
    """Same-width integer dtype the ABFT checksum runs in."""
    return _CHECKSUM_INT[torch.empty((), dtype=dtype).element_size()]


def _wrap(total, itype):
    """An exact int64 sum wrapped to the signed ``itype``: mod 2**width,
    as the reference's int32 wraparound sum (then its truncation to int16
    for 2-byte lanes) gives it."""
    bits = 8 * torch.empty((), dtype=itype).element_size()
    total = torch.remainder(total, 1 << bits)
    return torch.where(total >= 1 << (bits - 1), total - (1 << bits),
                       total).to(itype)


def tile_checksum(tiles):
    """Bit-pattern column checksum of ``(..., Cb, Kb)`` tiles: bitcast to
    the same-width int, sum along the Cb axis mod 2**width."""
    itype = checksum_int_dtype(tiles.dtype)
    bits = tiles.contiguous().view(itype)
    return _wrap(bits.sum(dim=-2, dtype=torch.int64), itype)


def append_checksum_row(tiles):
    """Append the checksum as one extra Cb row, bitcast back into the tile
    dtype so the slab stays one homogeneous tensor (the GEMMs never read
    it)."""
    row = tile_checksum(tiles)[..., None, :].view(tiles.dtype)
    return torch.cat([tiles, row], dim=-2)


def checksum_mismatches(tiles):
    """int32 count of checksum lanes of ``(..., Cb + 1, Kb)`` checksummed
    tiles that disagree with a recomputed sum (0: intact).  A lane is one
    (tile, spatial position, column); on a whole slab this is the armed
    kernels' verdict."""
    itype = checksum_int_dtype(tiles.dtype)
    want = tiles[..., -1:, :].contiguous().view(itype)
    got = tile_checksum(tiles[..., :-1, :])[..., None, :]
    return (want != got).sum(dtype=torch.int32)


def resolve_slab(w, w_packed, plan: WeightPlan, pack_fn):
    """The weight slab a kernel launch will read: the staged slab when one
    was handed in, else packed now — with the one shape check that keeps a
    stale slab from ever reaching a kernel."""
    w_tiles = pack_fn(w) if w_packed is None else w_packed
    if tuple(w_tiles.shape) != (plan.n_tiles, *plan.tile_shape):
        raise ValueError(("staged weight slab does not match this call's "
                          "plan", tuple(w_tiles.shape), plan))
    return w_tiles


class WeightStager:
    """Cross-layer weight staging: pack layer N+1's slab right after layer
    N is issued (the packing is queued behind layer N's kernels on the
    stream) and cache it under a caller-chosen key, so a stager bound to
    one parameter set packs each slab once across forward passes.

    ``verify=True`` checks a cache hit instead of trusting its key: a value
    that carries a pack-time fingerprint (``nn.conv.SlabFingerprint``) is
    re-verified — shape, dtype, crc32 of its bytes and, when the caller
    passes ``expect``, the pack context.  A mismatch counts in
    ``integrity_failures``, evicts the entry and repacks it, so a corrupted
    or stale cached slab never reaches a kernel.  The crc32 copies the
    slab to the host, so verification is opt-in.
    """

    def __init__(self, *, verify: bool = False):
        self._cache: dict = {}
        self.hits = 0
        self.misses = 0
        self.verify = verify
        self.integrity_failures = 0

    @staticmethod
    def _intact(val, expect) -> bool:
        """Values without a fingerprint have nothing to verify against."""
        fp = getattr(val, "fingerprint", None)
        return fp is None or fp.matches(val, expect=expect)

    def stage(self, key, fn, *args, expect=None, **kwargs):
        """Compute (or recall) ``fn(*args)`` for ``key``; returns the value."""
        if key in self._cache:
            val = self._cache[key]
            if not self.verify or self._intact(val, expect):
                self.hits += 1
                return val
            self.integrity_failures += 1
            del self._cache[key]        # repack from the pristine params
        val = fn(*args, **kwargs)
        self.misses += 1
        if key is not None:
            self._cache[key] = val
        return val

    def get(self, key, default=None):
        """The value staged under ``key``, else ``default`` (the classifier
        takes fc6's staged stream this way)."""
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        return default
