"""Logical-axis sharding rules (the reference's
``repro/parallel/sharding.py``), on ``torch.distributed``'s DeviceMesh.

A rules table maps logical axis names to mesh axes; :func:`_resolve` turns
a tensor's logical axes into a :class:`PartitionSpec` (one entry a tensor
dim: None, a mesh axis, or a tuple of axes the dim is split over in mesh
order), dropping indivisible or absent axes and never using one mesh axis
twice.  :meth:`PartitionSpec.placements` gives the DTensor placements of a
spec: for each mesh dim ``Shard(d)`` where tensor dim d names it, else
``Replicate()``.  The tables are the reference's, letter for letter.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
(``launch/mesh.py`` builds them) or, where only the specs are wanted, a
mesh shape ``{axis name: size}`` in mesh order: the specs need no process
group.

Parameter paths are the reference layout's keys joined with "/", so the
regexes match as they do there.  A per-layer leaf of the port's layer list
(``params["stack"][i]``) has no leading ``"layers"`` dim; the rules map
that dim to None, so its spec is the reference's without that entry.

:func:`constrain` is the identity on a plain tensor and a ``redistribute``
on a DTensor; the port's layers do not call it.  Where the reference
leaves GSPMD to derive each rank's block from its ``constrain`` hints, the
port's layers compute it explicitly: under an active DeviceMesh whose
``model`` axis has more than one rank (:func:`model_share`), each layer
takes its blocks of the parameters (``nn/layers.py::block``), picks its
regime from :func:`splits` (a :func:`_resolve` of the logical axis) and
:func:`heads_parallel` (the reference's attention regime test), and moves
activations over the ``model`` group with ``parallel/collectives.py``'s
autograd pairs.  A cache leaf holds the rank's block by
:data:`CACHE_AXES` (:func:`cache_block`).  :func:`batch_mean` is the one
reduction over the batch inside a model (the MoE router's load-balance
statistics): under an active DeviceMesh the model runs on the rank's share
of the global batch (``runtime/trainer.py``'s mesh step), and the mean is
taken over the ranks of the batch axes too.  Under ``--fsdp`` placements
(:func:`zero1_shardings` for the params too) a parameter is split over
"data" as well: :func:`layer_params`, which every layer and every use of a
leaf outside the stack calls, gathers it there (autograd-aware: the
backward reduce-scatters), the reference's per-layer all-gathers.
"""
from __future__ import annotations

import re
import sys
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch

from ..nn.module import tree_map, tree_map_with_path

# --- default logical -> mesh-axis rules -------------------------------------
# "pod" composes as an outer data axis by default (multi-pod DP); the
# pipeline launcher re-purposes it as a stage axis instead.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": "model",        # SP: layer-boundary residual sharded along seq
    "embed": None,
    "heads": "model",          # attention heads (activations)
    "kv_heads": "model",       # kv heads (dropped automatically if indivisible)
    "head_dim": None,
    "qkv_flat": "model",       # flattened H*head_dim param dim
    "mlp": "model",
    "vocab": "model",
    "experts": "model",        # EP: expert dim of MoE weights / dispatch
    "expert_group": ("pod", "data"),   # MoE token groups stay data-sharded
    "expert_mlp": None,
    "ssm_inner": "model",      # mamba d_inner
    "ssm_heads": "model",
    "state": None,
    "kv_lora": None,
    "cache_seq": "model",      # decode KV cache sharded along sequence (SP)
    "cache_kv_heads": None,
    "frames": None,
    "layers": None,
    "stage": "pipe",           # pipeline-parallel stage axis (opt-in meshes)
}

_ACTIVE: dict = {"mesh": None, "rules": dict(DEFAULT_RULES)}


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def placements(self, mesh) -> tuple:
        """DTensor placements on ``mesh``, one a mesh dim.  A tensor dim
        split over several mesh axes takes one ``Shard`` on each, and
        DTensor splits it in mesh order, as the reference does for
        ("pod", "data"); a spec naming them in another order is
        refused."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(axis_sizes(mesh))
        dim_of = {}
        for d, entry in enumerate(self):
            axes = _axes(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"{self}: dim {d} splits over {axes}, "
                                 f"not in the mesh's order {names}")
            dim_of.update((a, d) for a in axes)
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in names)


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return self.spec.placements(self.mesh)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a DeviceMesh or of a mesh
    shape given as such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextmanager
def use_mesh_rules(mesh, rules: Optional[dict] = None):
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def active_mesh():
    return _ACTIVE["mesh"]


def _mesh_axes_size(sizes: dict, axes) -> int:
    size = 1
    for a in _axes(axes):
        size *= sizes.get(a, 1)
    return size


def _resolve(mesh, logical_axes, shape) -> PartitionSpec:
    """Map logical axes -> PartitionSpec, dropping indivisible/absent axes and
    never using one mesh axis twice."""
    rules = _ACTIVE["rules"]
    sizes = axis_sizes(mesh)
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical_axes):
        target = rules.get(name) if name else None
        if target is None:
            spec.append(None)
            continue
        axes = tuple(a for a in _axes(target) if a in sizes and a not in used)
        if not axes or dim % _mesh_axes_size(sizes, axes) != 0:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes if len(axes) > 1 else axes[0])
    return P(*spec)


def logical_sharding(shape, logical_axes, mesh=None) -> NamedSharding:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise ValueError("no active mesh")
    return NamedSharding(mesh, _resolve(mesh, logical_axes, shape))


def constrain(x, logical_axes):
    """A DTensor redistributed to its logical axes' placements on the
    active mesh; a plain tensor, or any tensor without a mesh, as it is."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{logical_axes} vs rank {x.ndim}")
    if not is_dtensor(x):
        return x
    spec = _resolve(mesh, logical_axes, x.shape)
    return x.redistribute(x.device_mesh, spec.placements(x.device_mesh))


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over the rank's share of the batch, as the mean over
    the global batch: averaged (autograd-aware) over the ranks of the
    active DeviceMesh's batch axes; ``x`` itself without one.  Exact when
    every rank holds as many rows, as the mesh step's even split gives."""
    mesh = active_mesh()
    if mesh is None or isinstance(mesh, dict):
        return x
    from torch.distributed.nn.functional import all_reduce
    _, n = batch_share(mesh)
    for group in batch_groups(mesh):
        x = all_reduce(x, group=group)
    return x / n if n > 1 else x


def _batch_axes(mesh) -> tuple:
    """The mesh axes the batch rule splits over."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in _axes(_ACTIVE["rules"].get("batch"))
                 if a in sizes)


def batch_share(mesh) -> tuple:
    """(index, count): this rank's share of the global batch under the
    active rules' batch axes (row-major over them, as the reference's
    ``batch_sharding`` splits the batch dim), and their number."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    index, count = 0, 1
    for a in _batch_axes(mesh):
        index, count = index * sizes[a] + coord[a], count * sizes[a]
    return index, count


def batch_groups(mesh) -> list:
    """The process groups of the batch axes (a one-rank axis's too: its
    collectives move nothing)."""
    return [mesh.get_group(a) for a in _batch_axes(mesh)]


@dataclass(frozen=True)
class ModelShare:
    """This rank's place on the active mesh's ``model`` axis (or on the
    axis :func:`layer_params` gathers over): its index, the axis's size
    and its process group."""
    rank: int
    size: int
    group: object

    def block(self, n: int) -> tuple:
        """[lo, hi) of this rank's block of a dim of ``n`` split evenly."""
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b


_AT_ONE = [False]


@contextmanager
def tensor_parallel_at_one():
    """Inside, a ``model`` axis of one rank runs the tensor-parallel
    layers too (its collectives move nothing), and a "data" axis of one
    rank splits the parameters under ``--fsdp`` (:func:`zero1_shardings`
    places "data" there too) and gathers them per layer
    (:func:`layer_params`, one-rank collectives): the card's one-rank
    check of those code paths, which gives the one-device step's bits."""
    prev = _AT_ONE[0]
    _AT_ONE[0] = True
    try:
        yield
    finally:
        _AT_ONE[0] = prev


def model_share(mesh=None) -> Optional[ModelShare]:
    """The :class:`ModelShare` of the active DeviceMesh (or ``mesh``), or
    None where there is none, it is a mesh shape only, or its ``model``
    axis has one rank (outside :func:`tensor_parallel_at_one`): the
    layers then run their one-device code."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or isinstance(mesh, dict) or "model" not in \
            mesh.mesh_dim_names:
        return None
    sizes = axis_sizes(mesh)
    if sizes["model"] == 1 and not _AT_ONE[0]:
        return None
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return ModelShare(coord["model"], sizes["model"], mesh.get_group("model"))


def splits(name: str, n: int) -> bool:
    """Whether the active rules split a dim of logical axis ``name`` and
    size ``n`` over ``model`` (:func:`_resolve`'s answer: dropped where it
    does not divide or the rule names another axis)."""
    mesh = active_mesh()
    if mesh is None:
        return False
    entry = _resolve(mesh, (name,), (n,))[0]
    if entry is not None and "model" in _axes(entry) and entry != "model":
        raise NotImplementedError(f"{name}: split over {entry}; the "
                                  "layers split a dim over 'model' alone")
    return entry == "model"


def heads_parallel(num_heads: int, share: Optional[ModelShare]) -> bool:
    """The reference's attention regime (``nn/attention.py``): the heads
    split over ``model`` where they divide (head-parallel); otherwise q is
    split along the sequence and K/V are replicated."""
    return share is None or num_heads % share.size == 0


# logical axes of each cache leaf, by its name (the reference's
# ``launch/specs.py`` table; the port's ``clen`` by its slots)
CACHE_AXES = {
    "k": ("batch", "cache_seq", "cache_kv_heads", "head_dim"),
    "v": ("batch", "cache_seq", "cache_kv_heads", "head_dim"),
    "ck": ("batch", "cache_seq", "cache_kv_heads", "head_dim"),
    "cv": ("batch", "cache_seq", "cache_kv_heads", "head_dim"),
    "ckv": ("batch", "cache_seq", "kv_lora"),
    "kpe": ("batch", "cache_seq", None),
    "conv_x": ("batch", None, "ssm_inner"),
    "conv_b": ("batch", None, None),
    "conv_c": ("batch", None, None),
    "state": ("batch", "ssm_heads", "state", None),
    "clen": ("batch",),
}


def cache_block(t, name: str, share: ModelShare):
    """(this rank's block of cache leaf ``t`` (a view: writes land in
    ``t``), the leaf's whole shape): the dims :data:`CACHE_AXES` split
    over ``model`` cut to the rank's block.  A DTensor placed by
    ``launch/specs.py::cache_shardings`` holds that block already; a
    plain tensor is taken as whole on every rank and cut."""
    shape = tuple(t.shape)
    loc = local(t)
    spec = _resolve(active_mesh(), CACHE_AXES[name], shape)
    for d, entry in enumerate(spec):
        if entry == "model" and loc.shape[d] == shape[d]:
            lo, hi = share.block(shape[d])
            loc = loc.narrow(d, lo, hi - lo)
    return loc, shape


# --- parameter sharding by path ----------------------------------------------
# regex on the parameter path (dict keys joined with '/'); value = logical
# axes of the *trailing* dims (left-padded with "layers"/None for stacked
# leaves created by scan-over-layers vmapped init).
PARAM_RULES = [
    (r"embedding$", ("vocab", "embed")),
    (r"(wq|wkv|wk|wv|wuk|wuv|in_proj|wqkv)/w$", ("embed", "qkv_flat")),
    (r"(wo|out_proj)/w$", ("qkv_flat", "embed")),
    (r"wdkv/w$", ("embed", None)),                    # MLA down-proj (small)
    (r"(w1|w3)/w$", ("embed", "mlp")),
    (r"w2/w$", ("mlp", "embed")),
    (r"router/w$", ("embed", None)),
    (r"experts/(w1|w3)$", ("experts", "embed", "expert_mlp")),
    (r"experts/w2$", ("experts", "expert_mlp", "embed")),
    (r"conv/w$", (None, "ssm_inner")),
    (r"(A_log|D|dt_bias)$", ("ssm_heads",)),
    (r"(patch_proj)/w$", ("embed", None)),
]


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def param_logical_axes(path, leaf) -> tuple:
    s = path_str(path)
    # BFP-quantized linear weights: w_q (KB, block, N) / w_e (KB, N) inherit
    # the underlying w (K, N) rule with the block dim unsharded.
    bfp_kind = None
    if s.endswith("/w_q") or s.endswith("/w_e"):
        bfp_kind = s[-1]
        s = s[:-2]
    for pat, axes in PARAM_RULES:
        if re.search(pat, s):
            if bfp_kind == "q" and len(axes) == 2:
                axes = (axes[0], None, axes[1])
            pad = leaf.ndim - len(axes)
            return ("layers",) * pad + tuple(axes) if pad >= 0 else tuple(axes)[-leaf.ndim:]
    return (None,) * leaf.ndim   # norms, biases, scalars: replicated


def param_shardings(params, mesh):
    """Tree of :class:`NamedSharding` for a param tree (tensors, or
    anything with ``ndim`` and ``shape``)."""
    def one(path, leaf):
        axes = param_logical_axes(path, leaf)
        return NamedSharding(mesh, _resolve(mesh, axes, leaf.shape))
    return tree_map_with_path(one, params)


def batch_sharding(mesh, ndim: int = 2) -> NamedSharding:
    """Inputs: batch dim sharded over (pod, data)."""
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return NamedSharding(mesh, P(axes if len(axes) > 1 else (axes[0] if axes else None),
                                 *([None] * (ndim - 1))))


def data_parallel_mesh(devices=None) -> tuple:
    """The 1-axis ("data",) mesh of serving-style pure data parallelism:
    a tuple of devices, every visible card by default.  One process
    drives them all, as the reference's one program does; it needs no
    process group."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise RuntimeError("data_parallel_mesh: no visible card "
                           "(torch.cuda.device_count() is 0); pass the "
                           "devices to run elsewhere")
    return devices


def replicated_sharding(mesh) -> NamedSharding:
    """Fully replicated placement on ``mesh`` (weights under pure DP, or the
    fallback for batches indivisible by the data axis)."""
    return NamedSharding(mesh, P())


def zero1_shardings(params, mesh):
    """ZeRO-1: optimizer moments additionally sharded over 'data' on the
    largest divisible dim that the param sharding leaves unsharded (a
    one-rank 'data' axis only inside :func:`tensor_parallel_at_one`)."""
    dsize = axis_sizes(mesh).get("data", 1)

    def upgrade(path, leaf):
        ns = NamedSharding(mesh, _resolve(
            mesh, param_logical_axes(path, leaf), leaf.shape))
        spec = list(ns.spec) + [None] * (len(leaf.shape) - len(ns.spec))
        if dsize == 1 and not _AT_ONE[0]:
            return ns
        # pick the largest unsharded dim divisible by the data axis
        cands = [(d, i) for i, d in enumerate(leaf.shape)
                 if spec[i] is None and d % dsize == 0]
        if not cands:
            return ns
        _, i = max(cands)
        spec[i] = "data"
        return NamedSharding(mesh, P(*spec))

    return tree_map_with_path(upgrade, params)


# --- DTensor placement ---------------------------------------------------------
def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor: no tensor is
    one before ``torch.distributed.tensor`` is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` on ``mesh`` (a
    view): each ``Shard(d)`` in mesh order cuts dim d into the mesh dim's
    size and keeps this rank's coordinate, as DTensor lays shards out."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    for size, c, pl in zip(mesh.shape, coord, placements):
        if pl.is_shard() and size > 1:
            d = pl.dim
            if full.shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                                 f"divide into {size}")
            full = full.narrow(d, c * (full.shape[d] // size),
                               full.shape[d] // size)
    return full


def place(full: torch.Tensor, sharding: NamedSharding):
    """``full`` (every rank's copy alike) as a DTensor laid out by
    ``sharding``; each rank keeps a copy of its own block only."""
    from torch.distributed.tensor import DTensor
    mesh, pl = sharding.mesh, sharding.placements
    loc = local_slice(full.detach(), mesh, pl).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def full(t):
    """A DTensor gathered whole on every rank (a collective over its
    mesh; where no mesh dim of more than one rank shards it, its own
    block, with no call into DTensor's redistribution); any other leaf as
    it is."""
    if not is_dtensor(t):
        return t
    if all(p.is_replicate() or size == 1
           for p, size in zip(t.placements, t.device_mesh.shape)):
        return t.to_local()
    return t.full_tensor()


def local(t):
    """A DTensor's block on this rank (its storage: an in-place update
    changes the DTensor); any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def model_block(t):
    """This rank's block of a DTensor over ``model`` alone: gathered over
    every other mesh axis that shards it (none under the default rules;
    the moments' and ``--fsdp``'s "data"), else its own block with no
    collective; any other tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    keep = tuple(pl if name == "model" or size == 1 else Replicate()
                 for name, size, pl in zip(mesh.mesh_dim_names, mesh.shape,
                                           t.placements))
    if keep != tuple(t.placements):
        t = t.redistribute(mesh, keep)
    return t.to_local()


def gathered_axes(t) -> tuple:
    """The mesh axes a layer gathers DTensor ``t`` over before use: each
    axis other than ``model`` that shards it and has more than one rank
    (inside :func:`tensor_parallel_at_one`, one rank too), in mesh order;
    () for any other tensor."""
    if not is_dtensor(t):
        return ()
    mesh = t.device_mesh
    return tuple(name for name, size, pl in zip(
        mesh.mesh_dim_names, mesh.shape, t.placements)
        if name != "model" and pl.is_shard() and (size > 1 or _AT_ONE[0]))


@dataclass(frozen=True)
class Placed:
    """A parameter the layers gather (:func:`gathered_axes`) as the mesh
    step hands it to them: ``block``, the rank's block that autograd
    differentiates, and ``param``, the DTensor it is the block of."""
    block: torch.Tensor
    param: object


def layer_params(tree):
    """The tensors a layer computes with: each DTensor leaf of ``tree`` (or
    :class:`Placed` block) as its ``model`` block, gathered over
    :func:`gathered_axes` (the parameters ``--fsdp`` splits over "data")
    through ``collectives.gather_many``, whose backward reduce-scatters
    the gradient back to the rank's block; every other leaf as
    :func:`local` gives it.  The leaves gathered over one axis gather in
    one autograd node, innermost axis first, so every rank issues the
    same collectives, in the backward too."""
    from . import collectives as coll
    leaves = []
    tree_map(leaves.append, tree)
    placed = [t.param if isinstance(t, Placed) else t for t in leaves]
    out = [t.block if isinstance(t, Placed) else local(t) for t in leaves]
    split = [i for i, t in enumerate(placed) if gathered_axes(t)]
    if split:
        mesh = placed[split[0]].device_mesh
        names = mesh.mesh_dim_names
        coord = dict(zip(names, mesh.get_coordinate()))
        for axis in reversed(names):          # the innermost axis first
            idx = [i for i in split if axis in gathered_axes(placed[i])]
            if not idx:
                continue
            dims = [placed[i].placements[names.index(axis)].dim
                    for i in idx]
            if "model" in names and any(
                    placed[i].placements[names.index("model")].is_shard(d)
                    for i, d in zip(idx, dims)):
                raise ValueError(f"a leaf split over {axis!r} and 'model' "
                                 "on one dim")
            share = ModelShare(coord[axis], axis_sizes(mesh)[axis],
                               mesh.get_group(axis))
            for i, g in zip(idx, coll.gather_many([out[i] for i in idx],
                                                  dims, share)):
                out[i] = g
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def model_sharded(t) -> bool:
    """Whether DTensor ``t`` is split over a ``model`` axis of more than
    one rank."""
    if not is_dtensor(t):
        return False
    return any(name == "model" and size > 1 and pl.is_shard()
               for name, size, pl in zip(t.device_mesh.mesh_dim_names,
                                         t.device_mesh.shape, t.placements))


def shard_of(whole: torch.Tensor, like) -> torch.Tensor:
    """The block of ``whole`` that this rank holds of ``like`` (a DTensor
    of ``whole``'s shape), or ``whole`` where ``like`` is no DTensor."""
    if not is_dtensor(like):
        return whole
    return local_slice(whole, like.device_mesh, like.placements)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching :class:`NamedSharding`
    of ``shardings``."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s) for v, s in zip(tree, shardings,
                                                           strict=True))
    return place(tree, shardings)
