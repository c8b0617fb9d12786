"""Packed weight slabs shared by the conv kernels, and cross-layer staging.

Tile order contract (the reference's ``kernels/conv/dma.py``): the packed
slab is ``(n_tiles, *spatial, Cb, Kb)`` with tile ``lin = k * ncb + c`` for
group-major K blocks ``k in [0, g*nkb)`` and C blocks ``c in [0, ncb)``.
The CUDA kernels index this layout directly.  The reference's in-kernel
double-buffered DMA stream has no counterpart here: a GPU block reads its
weights through L2/L1 (see the kernels' source notes).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WeightPlan:
    """Blocking of one layer's weight slab into tiles.

    ``spatial`` is the per-tile filter extent — ``(n, n)`` Winograd-domain
    or ``(r, r)`` direct.  The reference's ABFT checksum row is not ported
    yet (ROADMAP Queue 1, item 1).
    """
    g: int                  # groups
    nkb: int                # K blocks per group
    ncb: int                # C blocks
    Cb: int                 # channel block
    Kb: int                 # output-channel block
    spatial: tuple          # per-tile filter dims

    @property
    def n_tiles(self) -> int:
        return self.g * self.nkb * self.ncb

    @property
    def tile_shape(self) -> tuple:
        return (*self.spatial, self.Cb, self.Kb)


def pack_weight_tiles(wg, plan: WeightPlan):
    """(g, *spatial, ncb*Cb, nkb*Kb) blocked weights -> (n_tiles, *tile)."""
    g, ncb, Cb, nkb, Kb = plan.g, plan.ncb, plan.Cb, plan.nkb, plan.Kb
    ns = len(plan.spatial)
    assert tuple(wg.shape) == (g, *plan.spatial, ncb * Cb, nkb * Kb), (
        tuple(wg.shape), plan)
    w7 = wg.reshape(g, *plan.spatial, ncb, Cb, nkb, Kb)
    # (g, *spatial, ncb, Cb, nkb, Kb) -> (g, nkb, ncb, *spatial, Cb, Kb)
    perm = (0, ns + 3, ns + 1, *range(1, ns + 1), ns + 2, ns + 4)
    return w7.permute(perm).reshape(plan.n_tiles, *plan.spatial, Cb,
                                    Kb).contiguous()


def unpack_weight_tiles(tiles, plan: WeightPlan):
    """Inverse of :func:`pack_weight_tiles`:
    (n_tiles, *spatial, Cb, Kb) -> (g, *spatial, ncb*Cb, nkb*Kb)."""
    g, ncb, Cb, nkb, Kb = plan.g, plan.ncb, plan.Cb, plan.nkb, plan.Kb
    ns = len(plan.spatial)
    t7 = tiles.reshape(g, nkb, ncb, *plan.spatial, Cb, Kb)
    # (g, nkb, ncb, *spatial, Cb, Kb) -> (g, *spatial, ncb, Cb, nkb, Kb)
    perm = (0, *range(3, 3 + ns), 2, 3 + ns, 1, 4 + ns)
    return t7.permute(perm).reshape(g, *plan.spatial, ncb * Cb, nkb * Kb)


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
    one parameter set packs each slab once across forward passes."""

    def __init__(self):
        self._cache: dict = {}
        self.hits = 0
        self.misses = 0

    def stage(self, key, fn, *args, **kwargs):
        """Compute (or recall) ``fn(*args)`` for ``key``; returns the value."""
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        val = fn(*args, **kwargs)
        self.misses += 1
        if key is not None:
            self._cache[key] = val
        return val
