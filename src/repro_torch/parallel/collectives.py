"""BFP-compressed gradient collectives (the reference's
``repro/parallel/collectives.py``, paper §3.6 -> distributed training).

The shared-exponent trick applied to the wire: a ring reduce-scatter whose
per-hop payload is int8 mantissas + one int8 exponent per block (~1.9x fewer
bytes than bf16, ~3.8x fewer than f32), with f32 accumulation at every hop so
error does not compound multiplicatively.  The reference builds it on
shard_map + ppermute; here each hop is a ``dist.batch_isend_irecv`` pair
over a process group (a mesh dim's: ``mesh.get_group(axis)``) and the
all-gather is ``dist.all_gather_into_tensor``, in the reference's order:
rank d seeds the ring with chunk (d+1) % n, each hop adds chunk (d-s) % n,
the gathered chunks are rolled by 2.  With the same BFP rounding
(``core/bfp.py``) the result is the reference's to the bit.  The
quantization runs in PyTorch ops, as the reference's runs in jnp outside
any Pallas kernel.

The collectives of tensor-parallel compute over ``model`` (the ones GSPMD
inserts in the reference) are autograd functions on a
``sharding.ModelShare``'s group, eager c10d ops the dry run's counter
counts (``core/opcount.py``; the backward of one issued inside a layer
counts as the layer's).  Their gradients keep one convention: the
gradient a rank holds of a tensor every rank holds alike (a replicated
activation or parameter) is its share, and the gradient is the sum of the
shares over the ``model`` ranks; of a tensor that is the rank's own (its
block of a split dim, or its partial sum) the gradient is whole.  So
:func:`reduce_sum` (partial sums -> their sum) and :func:`gather` (blocks
-> the whole) sum shares in their backward (an all-reduce and a
reduce-scatter), :func:`reduce_scatter` gathers, :func:`split` (the
whole -> the rank's block) pads with zeros and moves nothing, and the
training step seeds each rank's loss with 1 / model and sums the
replicated leaves' gradients over the group (``runtime/trainer.py``).
:func:`gather_many` is the same gather over a mesh dim that splits the
parameters (``--fsdp``'s "data"): a layer gathers its blocks just before
use, and the backward's reduce-scatter hands each rank the gradient of
its own block, summed over the group.  Every sum over ranks is the
backend's ring, whose order is fixed: no float atomics, and every rank
gets the same bits.
"""
from __future__ import annotations

import torch

from ..core import bfp, opcount
from ..nn.module import tree_map


def _dist():
    import torch.distributed as dist
    return dist


def _ring_rs(x, group, *, block: int, bits: int):
    """Ring reduce-scatter with BFP-compressed hops.

    x: (n * chunk,) this rank's copy.  Returns this rank's reduced chunk:
    after n-1 hops rank d owns the fully reduced chunk (d+2) % n."""
    dist = _dist()
    n, d = dist.get_world_size(group), dist.get_rank(group)
    chunks = x.reshape(n, -1)
    nxt = dist.get_global_rank(group, (d + 1) % n)
    prv = dist.get_global_rank(group, (d - 1) % n)

    # Rank d seeds the ring with its copy of chunk (d+1)%n; each hop the
    # partial moves d -> d+1 and the receiver adds its local copy.
    acc = chunks[(d + 1) % n]
    for s in range(n - 1):
        m, e, ax = bfp.quantize(acc.reshape(-1), block=block, bits=bits)
        rm, re_ = torch.empty_like(m), torch.empty_like(e)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, m, nxt, group),
                dist.P2POp(dist.isend, e, nxt, group),
                dist.P2POp(dist.irecv, rm, prv, group),
                dist.P2POp(dist.irecv, re_, prv, group)]):
            req.wait()
        recv = bfp.dequantize(rm, re_, bits=bits, axis=ax).reshape(acc.shape)
        acc = recv + chunks[(d - s) % n]
    return acc


def all_gather(t, group):
    """(n,) + t.shape: every rank's ``t``, gathered as bytes (gloo gathers
    no int16)."""
    dist = _dist()
    n = dist.get_world_size(group)
    raw = t.contiguous().view(torch.uint8).reshape(-1)
    out = torch.empty(n * raw.numel(), dtype=torch.uint8, device=t.device)
    dist.all_gather_into_tensor(out, raw, group=group)
    return out.view(t.dtype).reshape((n,) + t.shape)


def _moved(x, dim):
    """``x`` with ``dim`` first, contiguous (the layout c10d's tensor
    collectives split and concatenate along)."""
    return x.movedim(dim, 0).contiguous()


def _all_gather_dim(x, dim, share):
    dist = _dist()
    xs = _moved(x, dim)
    out = xs.new_empty((share.size * xs.shape[0],) + tuple(xs.shape[1:]))
    # the tensor collectives' newer names where this PyTorch has them
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, xs, group=share.group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(x, dim, share):
    dist = _dist()
    xs = _moved(x, dim)
    out = xs.new_empty((xs.shape[0] // share.size,) + tuple(xs.shape[1:]))
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, xs, group=share.group)
    return out.movedim(0, dim).contiguous()


def _flat_dtype(ts):
    """The one dtype of ``ts``, which one buffer carries (``torch.cat``
    would promote a mixed list)."""
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1:
        raise ValueError(f"one collective of tensors of dtypes {dtypes}")


def _all_gather_dims(xs, dims, share) -> list:
    """Each of ``xs`` gathered along its dim of ``dims``: one all-gather
    of the blocks flattened (their dim first) into one buffer, each
    gathered tensor cut from its columns of the result."""
    if len(xs) == 1:
        return [_all_gather_dim(xs[0], dims[0], share)]
    _flat_dtype(xs)
    dist = _dist()
    moved = [_moved(x, d) for x, d in zip(xs, dims)]
    flat = torch.cat([m.reshape(-1) for m in moved])
    every = flat.new_empty(share.size * flat.numel())
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        every, flat, group=share.group)
    parts = every.view(share.size, -1).split([m.numel() for m in moved],
                                             dim=1)
    return [part.reshape((share.size * m.shape[0],) + tuple(m.shape[1:]))
            .movedim(0, d).contiguous()
            for part, m, d in zip(parts, moved, dims)]


def _reduce_scatter_dims(gs, dims, share) -> list:
    """Each of ``gs`` reduce-scattered along its dim of ``dims``: one
    reduce-scatter of a buffer whose rank-r chunk holds every tensor's
    rank-r block (their dim first)."""
    if len(gs) == 1:
        return [_reduce_scatter_dim(gs[0], dims[0], share)]
    _flat_dtype(gs)
    dist = _dist()
    n = share.size
    moved = [_moved(g, d) for g, d in zip(gs, dims)]
    flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
    mine = flat.new_empty(flat.shape[1])
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        mine, flat.reshape(-1), group=share.group)
    parts = mine.split([m.numel() // n for m in moved])
    return [part.view((m.shape[0] // n,) + tuple(m.shape[1:]))
            .movedim(0, d).contiguous()
            for part, m, d in zip(parts, moved, dims)]


def _all_reduce(x, share, op=None):
    dist = _dist()
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=share.group)
    return out


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share):
        ctx.share, ctx.layer = share, opcount.in_layer()
        return _all_reduce(x, share)

    @staticmethod
    def backward(ctx, g):
        with opcount.layer_scope(ctx.layer):
            return _all_reduce(g, ctx.share), None


class _Gather(torch.autograd.Function):
    """Each of ``xs`` gathered along its dim of ``dims`` over one group,
    in one collective.  One node for them all: its backward
    reduce-scatters every gradient the same way, zeros where no op used a
    tensor on this rank, so every rank issues the same collectives in the
    same order."""
    @staticmethod
    def forward(ctx, dims, share, *xs):
        ctx.dims, ctx.share, ctx.layer = dims, share, opcount.in_layer()
        return tuple(_all_gather_dims(xs, dims, share))

    @staticmethod
    def backward(ctx, *gs):
        with opcount.layer_scope(ctx.layer):
            return (None, None) + tuple(
                _reduce_scatter_dims(gs, ctx.dims, ctx.share))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, share):
        ctx.dim, ctx.share, ctx.layer = dim, share, opcount.in_layer()
        return _reduce_scatter_dim(x, dim, share)

    @staticmethod
    def backward(ctx, g):
        with opcount.layer_scope(ctx.layer):
            return _all_gather_dim(g, ctx.dim, ctx.share), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, share):
        ctx.dim, ctx.n, ctx.share = dim, x.shape[dim], share
        lo, hi = share.block(x.shape[dim])
        return x.narrow(dim, lo, hi - lo).clone()

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.share.block(ctx.n)
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n
        out = g.new_zeros(shape)
        out.narrow(ctx.dim, lo, hi - lo).copy_(g)
        return out, None, None


# on a group of one rank each of these moves nothing and returns its input
# (no call into the process group, no copy), as the mesh step skips its
# one-rank dims
def reduce_sum(x, share):
    """The sum over the ``model`` ranks of their partial sums ``x``
    (all-reduce), alike on every rank; backward an all-reduce of the
    shares."""
    return x if share.size == 1 else _ReduceSum.apply(x, share)


def gather(x, dim: int, share):
    """Every rank's block ``x`` concatenated along ``dim`` in rank order
    (all-gather); backward a reduce-scatter of the shares."""
    return x if share.size == 1 else _Gather.apply((dim,), share, x)[0]


def gather_many(xs, dims, share) -> tuple:
    """:func:`gather` of each of ``xs`` along its dim of ``dims`` in one
    autograd node and one all-gather (its backward one reduce-scatter), a group of one rank too (whose collectives move
    nothing): a layer's parameter blocks (``sharding.layer_params``)."""
    return _Gather.apply(tuple(dims), share, *xs)


def reduce_scatter(x, dim: int, share):
    """This rank's block along ``dim`` of the sum of the ranks' partial
    sums ``x`` (reduce-scatter); backward an all-gather."""
    return x if share.size == 1 else _ReduceScatter.apply(x, dim, share)


def split(x, dim: int, share):
    """This rank's block along ``dim`` of ``x``, held alike on every rank;
    no collective either way (the gradient's other blocks are zero)."""
    return x if share.size == 1 else _Split.apply(x, dim, share)


def gather_nograd(x, dim: int, share):
    """:func:`gather` outside autograd (the serving steps)."""
    return x if share.size == 1 else _all_gather_dim(x, dim, share)


def all_max(x, share):
    """The elementwise max over the ``model`` ranks (no gradient)."""
    if share.size == 1:
        return x.detach()
    return _all_reduce(x.detach(), share, _dist().ReduceOp.MAX)


def heads_to_rows(x, share):
    """All-to-all over the ``model`` ranks: ``x`` (m, ...), chunk d for
    rank d, -> (m, ...), chunk s from rank s."""
    if share.size == 1:
        return x
    dist = _dist()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=share.group)
    return out


def bfp_psum(x, group=None, *, block: int = 32, bits: int = 8):
    """All-reduce (sum) of ``x`` over ``group`` (None: the world) =
    compressed ring reduce-scatter + compressed all-gather; ``x`` as it is
    on a group of one."""
    dist = _dist()
    n = dist.get_world_size(group)
    if n == 1:
        return x
    orig_shape = x.shape
    size = x.numel()
    flat = x.reshape(-1)
    pad = (-size) % (n * block)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunk = _ring_rs(flat, group, block=block, bits=bits)  # this rank's chunk
    # compressed all-gather of the reduced chunks
    m, e, ax = bfp.quantize(chunk.reshape(-1), block=block, bits=bits)
    ms, es = all_gather(m, group), all_gather(e, group)  # (n,nb,blk), (n,nb)
    parts = bfp.dequantize(ms, es, bits=bits, axis=ax + 1)     # (n, chunk)
    # rank i holds reduced chunk (i+2)%n -> reorder to 0..n-1
    parts = torch.roll(parts, 2, dims=0)
    return parts.reshape(-1)[:size].reshape(orig_shape)


def make_compressed_grad_sync(mesh, axis: str = "data", *,
                              block: int = 32, bits: int = 8,
                              min_size: int = 1024):
    """Returns grads -> grads averaged over ``axis`` of ``mesh`` with BFP
    compression for large leaves (small leaves use an exact all-reduce)."""
    dist = _dist()
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def one(g):
        if g.numel() >= min_size and g.numel() % block == 0:
            s = bfp_psum(g, group, block=block, bits=bits)
        else:
            s = g.clone()
            dist.all_reduce(s, group=group)
        return s / n

    return lambda grads: tree_map(one, grads)


def all_reduce_coalesced(tensors, groups, *, cap: int = 1 << 26):
    """Sum each of ``tensors`` over every group of ``groups`` in turn, in
    place: one all-reduce a bucket of consecutive tensors of one dtype and
    at most ``cap`` elements (a larger tensor alone), as DDP buckets its
    gradients, in place of one a tensor."""
    dist = _dist()
    buckets, size = [], 0
    for t in tensors:
        if (not buckets or t.dtype != buckets[-1][0].dtype
                or size + t.numel() > cap):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    for bucket in buckets:
        alone = len(bucket) == 1 and bucket[0].is_contiguous()
        flat = (bucket[0].view(-1) if alone else
                torch.cat([t.reshape(-1) for t in bucket]))
        for g in groups:
            dist.all_reduce(flat, group=g)
        if not alone:
            for t, part in zip(bucket, flat.split(
                    [t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


def wire_bytes_ratio(bits: int = 8, block: int = 32,
                     baseline_bytes: int = 2) -> float:
    """Compression ratio vs an uncompressed ring (per hop)."""
    payload = block * (bits / 8) + 1      # mantissas + shared exponent
    return payload / (block * baseline_bytes)


def mesh_barrier(mesh):
    """Wait for every rank of ``mesh``: an all-reduce over each of its dims
    in turn (a rank outside the mesh takes no part)."""
    dist = _dist()
    t = torch.zeros(1, device=mesh.device_type)
    for name in mesh.mesh_dim_names:
        dist.all_reduce(t, group=mesh.get_group(name))
