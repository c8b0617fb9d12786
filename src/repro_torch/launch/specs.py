"""Stand-ins and step functions for every (arch x shape) cell (the
reference's ``repro/launch/specs.py``).

The stand-ins are ``meta`` tensors, the analogue of the reference's
``ShapeDtypeStruct``: shapes and dtypes, nothing allocated or drawn.
:func:`batch_specs`, :func:`cache_specs`, :func:`state_specs` and
:func:`serve_param_specs` give the inputs of the step a cell runs: train
-> ``train_step(state, batch)``; prefill and decode -> a serving step over
the caches.  The port's trees keep its own layout (a layer list, not the
reference's scan-stacked groups; ``models.lm.to_reference_layout`` stacks
them), and the state's ``step`` is the host scalar the port's AdamW keeps.
:func:`batch_shardings`, :func:`cache_shardings` and
:func:`state_shardings` place them on a mesh by the reference's rules
(``parallel/sharding.py``).

The step functions are the port's own: the ``Trainer``'s step
(``runtime/trainer.py::train_step``, with its mesh step
``mesh_grads``) and ``apply`` in prefill or decode mode.  Given a mesh, a
serving step does what the mesh training step does: each rank takes its
share of the batch rows (every row where the batch does not split over
the batch axes) and runs ``apply`` on them.  Where the mesh's ``model``
axis has one rank, it gathers the parameters whole (``sharding.full``)
and its rows of each cache over the other mesh axes, and writes its
block of each cache back; with more (tensor-parallel compute) it keeps
each parameter's ``model`` block (``sharding.model_block``) and hands
``apply`` the placed caches, whose layers read and write the rank's
blocks in place (``sharding.cache_block``), and the next token is the
argmax across the ranks' blocks of the vocabulary (``lm.greedy``).  The
training step follows from how its state is placed: under
:func:`state_shardings`' ``fsdp`` the params are split over "data" too,
and each layer gathers its leaves over "data" at its use and
reduce-scatters their gradients (``sharding.layer_params``); the serving
steps keep ``param_shardings``.  The same functions run on meta tensors
in the dry run (``launch/dryrun.py``) and on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..config import ArchConfig, ShapeCfg
from ..models import lm, model_for
from ..nn.module import tree_leaves, tree_map, tree_map_with_path
from ..parallel import sharding as shlib
from ..parallel.sharding import NamedSharding, P
from ..runtime.trainer import train_step

AUDIO_FRAMES = 1500      # whisper 30s encoder length (stub embeddings)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        out = {"inputs": _meta((B, S), i32), "targets": _meta((B, S), i32)}
        if cfg.family == "audio":
            out["frames"] = _meta((B, S, cfg.d_model), f32)
        if cfg.family == "vlm":
            out["patches"] = _meta((B, cfg.num_patches, 1024), f32)
        return out
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), i32)}
        if cfg.family == "audio":
            # the encoder takes its natural frame count (the cross cache's
            # size); the 32k prefill stresses the decoder's token length
            out["frames"] = _meta((B, AUDIO_FRAMES, cfg.d_model), f32)
        if cfg.family == "vlm":
            out["patches"] = _meta((B, cfg.num_patches, 1024), f32)
        return out
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((B, 1), i32)}


def cache_specs(cfg: ArchConfig, shape: ShapeCfg) -> list:
    """The caches of ``shape.global_batch`` slots of ``shape.seq_len``
    positions, per layer as ``apply`` takes them (an encoder-decoder's
    cross caches of :data:`AUDIO_FRAMES` rows)."""
    mod = model_for(cfg)
    kw = {"cross_len": AUDIO_FRAMES} if cfg.family == "audio" else {}
    return lm.zero_caches(mod.cache_shape(cfg, shape.global_batch,
                                          shape.seq_len, **kw), "meta")


def state_specs(cfg: ArchConfig, seed: int = 0) -> dict:
    """``{"step", "params", "m", "v"}``: the params' shapes and dtypes
    (``init`` on meta), f32 moments, the host step."""
    params = model_for(cfg).init(seed, cfg, device="meta")
    f32 = lambda t: tree_map(  # noqa: E731
        lambda x: _meta(x.shape, torch.float32), t)
    return {"step": torch.zeros((), dtype=torch.int32), "params": params,
            "m": f32(params), "v": f32(params)}


def serve_param_specs(cfg: ArchConfig, serve_dtype: str = "bf16",
                      seed: int = 0):
    """Serving weights: f32 master copies, bf16 inference copies, or the
    BFP-int8 shared-exponent streams of the large linears (``bfp8``,
    paper §3.6: ``models.lm.quantize_linear_tree`` on the bf16 copies)."""
    params = model_for(cfg).init(seed, cfg, device="meta")
    if serve_dtype == "f32":
        return params
    bf16 = tree_map(lambda x: _meta(x.shape, torch.bfloat16)
                    if x.is_floating_point() else x, params)
    if serve_dtype == "bf16":
        return bf16
    if serve_dtype == "bfp8":
        return lm.quantize_linear_tree(bf16, cfg)
    raise ValueError(serve_dtype)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------
def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shlib.axis_sizes(mesh))


def batch_shardings(cfg, shape, mesh, specs):
    """Each batch leaf's dim 0 split over ("pod", "data") where it
    divides, else replicated."""
    da = _data_axes(mesh)
    dspec = da if len(da) > 1 else (da[0] if da else None)
    size = math.prod(shlib.axis_sizes(mesh)[a] for a in da)

    def one(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim and leaf.shape[0] % max(1, size) == 0:
            spec[0] = dspec
        return NamedSharding(mesh, P(*spec))
    return tree_map(one, specs)


def cache_shardings(cfg, cache_spec, mesh):
    """Each cache leaf by its name's logical axes (the default rules, as
    the reference's; the port's ``clen`` by its slots), any leading dim
    replicated."""
    def one(path, leaf):
        name = shlib.path_str(path).split("/")[-1]
        axes = shlib.CACHE_AXES.get(name, (None,) * leaf.ndim)
        axes = ("layers",) * (leaf.ndim - len(axes)) + tuple(axes)
        return shlib.logical_sharding(leaf.shape, axes, mesh)
    with shlib.use_mesh_rules(mesh, None):
        return tree_map_with_path(one, cache_spec)


def state_shardings(cfg, state_spec, mesh, *, zero1: bool = True,
                    fsdp: bool = False):
    """zero1: the AdamW moments sharded over 'data' as well (ZeRO-1).
    fsdp: the parameters (and so their gradients' blocks) too; the step
    gathers each layer's leaves over 'data' just before use and
    reduce-scatters their gradients (ZeRO-3)."""
    z1 = shlib.zero1_shardings(state_spec["params"], mesh)
    pshard = z1 if fsdp else shlib.param_shardings(state_spec["params"],
                                                   mesh)
    moments = z1 if (zero1 or fsdp) else pshard
    return {"step": NamedSharding(mesh, P()), "params": pshard,
            "m": moments, "v": moments}


def place_state(state, shardings) -> dict:
    """A state (every rank's alike) placed by :func:`state_shardings`:
    params and moments DTensors, ``step`` the host scalar."""
    return {"step": state["step"],
            **{k: shlib.place_tree(state[k], shardings[k])
               for k in ("params", "m", "v")}}


# ---------------------------------------------------------------------------
# step functions (what the dry run counts; chip_smoke.py runs them too)
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, *, mesh=None, rules=None,
                    base_lr: float = 1e-4, total_steps: int = 10_000):
    """``step(state, batch) -> metrics``: the ``Trainer``'s step, updating
    ``state`` in place (under ``mesh`` the state is placed and ``batch``
    is the global batch, alike on every rank)."""
    mod = model_for(cfg)
    keys = ("inputs", "targets") + {"audio": ("frames",),
                                    "vlm": ("patches",)}.get(cfg.family, ())

    def step(state, batch):
        if mesh is None:
            for p in tree_leaves(state["params"]):
                p.requires_grad_(True)
        return train_step(mod, cfg, state, {k: batch[k] for k in keys},
                          base_lr=base_lr, warmup=100, total=total_steps,
                          weight_decay=0.01, clip_norm=1.0, mesh=mesh,
                          rules=rules)

    return step


def _rows(mesh, rules, n: int) -> tuple:
    """(index, count) of this rank's share of ``n`` batch rows: the batch
    axes' split, or all of them where ``n`` does not divide."""
    with shlib.use_mesh_rules(mesh, rules):
        index, count = shlib.batch_share(mesh)
    return (index, count) if n % count == 0 else (0, 1)


def _own_rows(t, mesh, rules):
    """This rank's rows of a placed cache leaf, every other dim whole: a
    gather over the mesh axes that shard it elsewhere."""
    if not shlib.is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    with shlib.use_mesh_rules(mesh, rules):
        batch_axes = set(shlib._batch_axes(mesh))
    keep = tuple(pl if pl.is_shard(0) and name in batch_axes
                 else Replicate()
                 for name, pl in zip(mesh.mesh_dim_names, t.placements))
    if keep == tuple(t.placements):
        return t.to_local()
    return t.redistribute(t.device_mesh, keep).to_local()


def _write_back(t, rows):
    """This rank's block of cache leaf ``t`` set from ``rows``, its rows
    with every other dim whole (the dims :func:`_own_rows` gathered)."""
    if not shlib.is_dtensor(t):
        return
    mesh = t.device_mesh
    for size, c, pl in zip(mesh.shape, mesh.get_coordinate(), t.placements):
        if pl.is_shard() and rows.shape[pl.dim] == t.shape[pl.dim]:
            n = rows.shape[pl.dim] // size
            rows = rows.narrow(pl.dim, c * n, n)
    t.to_local().copy_(rows)


def _serve_step(cfg: ArchConfig, mode: str, *, length=None, mesh=None,
                rules=None):
    mod = model_for(cfg)

    @torch.no_grad()
    def step(params, batch, caches):
        tokens = batch["tokens"]
        kw = {k: batch[k] for k in ("frames", "patches") if k in batch}
        local, share = caches, None
        if mesh is not None:
            with shlib.use_mesh_rules(mesh, rules):
                share = shlib.model_share(mesh)
                vshare = lm.vocab_share(cfg) if share else None
            index, count = _rows(mesh, rules, tokens.shape[0])
            n = tokens.shape[0] // count
            tokens = tokens[index * n:(index + 1) * n]
            kw = {k: v[index * n:(index + 1) * n] for k, v in kw.items()}
            if share is None:
                params = tree_map(shlib.full, params)
                local = tree_map(lambda t: _own_rows(t, mesh, rules), caches)
            else:
                params = tree_map(shlib.model_block, params)
        if mode == "decode":
            kw["length"] = length
        with (shlib.use_mesh_rules(mesh, rules) if share
              else contextlib.nullcontext()):
            logits, new, _ = mod.apply(params, cfg, tokens, mode=mode,
                                       caches=local, **kw)
        if share is not None:
            return lm.greedy(logits[:, -1], vshare), caches
        if mesh is not None:
            for t, r in zip(tree_leaves(caches), tree_leaves(new),
                            strict=True):
                _write_back(t, r)
            new = caches
        return logits[:, -1].argmax(-1).to(torch.int32), new

    return step


def make_prefill_step(cfg: ArchConfig, *, mesh=None, rules=None):
    """``step(params, batch, caches) -> (next tokens, caches)``: a prefill
    of ``batch["tokens"]`` from position 0 (an encoder-decoder's frames,
    a VLM's patches beside them), the caches filled in place."""
    return _serve_step(cfg, "prefill", mesh=mesh, rules=rules)


def make_decode_step(cfg: ArchConfig, shape: ShapeCfg, *, mesh=None,
                     rules=None):
    """``step(params, batch, caches) -> (next tokens, caches)``: one token
    a slot against caches holding ``shape.seq_len - 1`` positions."""
    return _serve_step(cfg, "decode", length=shape.seq_len - 1, mesh=mesh,
                       rules=rules)
