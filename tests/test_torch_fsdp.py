"""The per-layer gather under ``--fsdp`` on gloo ranks on the CPU.

``launch/specs.py::state_shardings(..., fsdp=True)`` splits the
parameters over "data" as well as "model" (ZeRO-3); the training step
(``specs.make_train_step``, ``runtime/trainer.py::mesh_grads``) then
hands each layer its leaves' blocks, the layer gathers them over "data"
just before use (``sharding.layer_params``) and the backward
reduce-scatters their gradients back to the rank's blocks, which AdamW
updates in place.

One spawn of 8 ranks builds two ("data", "model") meshes in turn: (8, 1),
pure FSDP, and (4, 2), FSDP with tensor-parallel compute.  On each, five
reduced archs at ``vocab_size`` 512 and with remat (the full configs'
default) take 2 steps (smollm-360m 3): smollm-360m, deepseek-v2-lite-16b
(MLA, the dense prefix), jamba-v0.1-52b (attention, Mamba with kernel 7's
plain version, MoE; selective remat keeping the flash output),
whisper-tiny (the encoder and decoder stacks) and phi-3-vision-4.2b (the
patch projection).  Each is held to the port's one-process step leaf by
leaf by name: the loss, ``grad_norm``, ``m``, ``v`` and the params after
every step, within rtol 1e-4 / atol 1e-5 on (8, 1) and the reference
test's rtol 2e-3 / atol 2e-4 on (4, 2).  ``m`` and ``v`` carry the gradients: during warmup
``lr_schedule`` gives steps of 0 to 2e-6, so the params alone would pass
with a wrong gradient.  The ranks record every per-layer gather: a stack
leaf is gathered only inside a layer, outside one only the embedding, the
norms, the readout and the patch projection are, and the gathered blocks
live at once never exceed one layer's (or the leaves outside the stack).
The (4, 2) smollm-360m run is held to the reference's own FSDP step,
``repro.launch.specs.make_train_step`` jitted with its
``state_shardings(fsdp=True)`` on a (4, 2) Auto-axis mesh of 8 forced host
devices, from the same params and batches.  The dry run's repair: a
full-width ``train_4k`` cell under ``--fsdp`` on the fake 16 x 16 world is
``ok``.  On one gloo rank, inside ``sharding.tensor_parallel_at_one`` (the
card's check), the FSDP-placed step gathers over the one-rank "data" axis
and is bit-equal to the meshless step.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
from _torch_ranks import ROOT, one_rank_group, run_ranks  # noqa: F401
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro_torch import checkpoint as ckpt
from repro_torch.launch import specs
from repro_torch.models import lm, model_for
from repro_torch.nn.module import tree_leaves, tree_map

ARCHS = ("smollm-360m", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
         "whisper-tiny", "phi-3-vision-4.2b")
MESHES = ((8, 1), (4, 2))
BOUNDS = {(8, 1): (1e-4, 1e-5), (4, 2): (2e-3, 2e-4)}
VOCAB, B, S, STEPS = 512, 8, 16, 3
TIMEOUT = 300              # the 8 ranks take ~35 s alone, 4x that under load
# outside the stack a step gathers these leaves only
OUTSIDE = ("embed/", "final_norm/", "enc_norm/", "lm_head/", "patch_proj/")

_COMMON = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config

VOCAB, B, S, STEPS = {vocab}, {b}, {s}, {steps}


# 3 steps for the reference's comparison, 2 for the others (lr 0, 1e-6)
def steps_of(arch):
    return STEPS if arch == "smollm-360m" else 2


def cfg_of(arch):
    return dataclasses.replace(
        get_config(arch).reduced(), vocab_size=VOCAB, remat=True,
        remat_policy="save_attn" if arch == "jamba-v0.1-52b" else "nothing")


def batch_of(cfg, step):
    g = np.random.default_rng(100 + step)
    b = {{"inputs": g.integers(0, VOCAB, (B, S)).astype(np.int32),
          "targets": g.integers(-1, VOCAB, (B, S)).astype(np.int32)}}
    if cfg.family == "audio":
        b["frames"] = g.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["patches"] = g.standard_normal(
            (B, cfg.num_patches, 1024)).astype(np.float32)
    return b


def names_of(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in names_of(tree[k], f"{{path}}/{{k}}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in names_of(v, f"{{path}}/{{i}}")]
    return [path]
"""

_RANKS = """
import weakref
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model_for
from repro_torch.nn import blocks
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.optim import init_state
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh

ARCHS, MESHES = {archs}, {meshes}
{common}
# every per-layer gather: the leaves' names, inside a layer or not, the
# gathered bytes; and the gathered bytes live at once
# (of every leaf, of the stack's leaves)
calls, in_layer, OWNERS = [], [0], {{}}
live, peak = [0, 0], [0, 0]
real_gather_many = coll.gather_many


def _freed(n, stack):
    live[0] -= n
    live[1] -= n * stack


def counting_gather_many(xs, dims, share):
    out = real_gather_many(xs, dims, share)
    names = [OWNERS.get(x.data_ptr(), "?") for x in xs]
    n = sum(t.numel() * t.element_size() for t in out)
    calls.append((names, bool(in_layer[0]), n))
    stack = all("stack/" in name for name in names)
    for t in out:
        weakref.finalize(t, _freed, t.numel() * t.element_size(), stack)
    live[0] += n
    live[1] += n * stack
    peak[:] = [max(p, v) for p, v in zip(peak, live)]
    return out


def marking(fn):
    def run(*a, **k):
        in_layer[0] += 1
        try:
            return fn(*a, **k)
        finally:
            in_layer[0] -= 1
    return run


# each DTensor of ``leaves`` whole: one all-gather of every rank's blocks
# in place of a ``full_tensor`` a leaf
def wholes(leaves, mesh):
    flat = torch.cat([sh.local(t).detach().reshape(-1) for t in leaves])
    every = torch.empty(WORLD * flat.numel())
    dist.all_gather_into_tensor(every, flat)
    out = [torch.empty(t.shape) for t in leaves]
    grid = mesh.mesh
    for r, part in enumerate(every.view(WORLD, -1)):
        coord = [int(c) for c in (grid == r).nonzero()[0]]
        off = 0
        for t, o in zip(leaves, out):
            for size, c, pl in zip(mesh.shape, coord, t.placements):
                if pl.is_shard():
                    n = o.shape[pl.dim] // size
                    o = o.narrow(pl.dim, c * n, n)
            o.copy_(part[off:off + o.numel()].view(o.shape))
            off += o.numel()
    return out


coll.gather_many = counting_gather_many
blocks.block_apply = marking(blocks.block_apply)
blocks.block_apply_tp = marking(blocks.block_apply_tp)

for shape in MESHES:
    mesh = make_mesh(tuple(shape), ("data", "model"))
    for arch in ARCHS:
        cfg = cfg_of(arch)
        mod = model_for(cfg)
        params = mod.init(0, cfg, device="cpu")
        names = names_of(params)
        state = init_state(params)
        with sh.use_mesh_rules(mesh):
            placed = specs.place_state(state, specs.state_shardings(
                cfg, state, mesh, fsdp=True))
        OWNERS.clear()
        OWNERS.update({{sh.local(p).data_ptr(): n for n, p in
                        zip(names, tree_leaves(placed["params"]))}})
        step = specs.make_train_step(cfg, mesh=mesh)
        rec = {{"steps": [], "split": sum(
            bool(sh.gathered_axes(p)) for p in tree_leaves(placed["params"]))}}
        for s in range(steps_of(arch)):
            del calls[:]
            peak[:] = live[:] = [0, 0]
            met = step(placed, {{k: torch.from_numpy(v) for k, v in
                                 batch_of(cfg, s).items()}})
            rec["steps"].append(dict(
                {{k: dict(zip(names, wholes(tree_leaves(placed[k]), mesh)))
                  for k in ("params", "m", "v")}},
                loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                calls=list(calls), peak=peak[0], stack_peak=peak[1]))
        if RANK == 0:
            torch.save(rec, f"{{OUT}}/{{arch}}_{{shape[0]}}x{{shape[1]}}.pt")
"""

_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import specs as sp
from repro.optim import init_state
from repro.parallel import sharding as shlib
out = sys.argv[1]
with open(out + "/reference_in.pkl", "rb") as f:
    given = pickle.load(f)
cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                          vocab_size=given["vocab"], remat=True)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
state = init_state(jax.tree_util.tree_map(jnp.asarray, given["params"]))
got = []
with shlib.use_mesh_rules(mesh):
    st_sh = sp.state_shardings(cfg, state, mesh, fsdp=True)
    b_sh = sp.batch_shardings(cfg, None, mesh, given["batches"][0])
    step = jax.jit(sp.make_train_step(cfg), in_shardings=(st_sh, b_sh),
                   out_shardings=(st_sh, None))
    state = jax.device_put(state, st_sh)
    for batch in given["batches"]:
        state, met = step(state, batch)
        got.append({"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    **{k: jax.tree_util.tree_map(np.asarray, state[k])
                       for k in ("params", "m", "v")}})
with open(out + "/reference.pkl", "wb") as f:
    pickle.dump(got, f)
print("OK")
"""

_CELL = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
rec = dryrun.run_cell("smollm-360m", "train_4k", fsdp=True)
with open(sys.argv[1] + "/cell.json", "w") as f:
    json.dump(rec, f)
print("OK")
"""

exec(_COMMON.format(vocab=VOCAB, b=B, s=S, steps=STEPS))


def _one_process(arch):
    """The port's one-process steps from the same params and batches:
    after each, the loss, ``grad_norm`` and every leaf of the params,
    ``m`` and ``v`` by name."""
    cfg = cfg_of(arch)
    mod = model_for(cfg)
    params = mod.init(0, cfg, device="cpu")
    names = names_of(params)
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "m": tree_map(torch.zeros_like, params),
             "v": tree_map(torch.zeros_like, params)}
    step = specs.make_train_step(cfg)
    out = []
    for s in range(steps_of(arch)):
        met = step(state, {k: torch.from_numpy(v)
                           for k, v in batch_of(cfg, s).items()})
        out.append({"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    **{k: {n: t.detach().clone() for n, t in
                           zip(names, tree_leaves(state[k]))}
                       for k in ("params", "m", "v")}})
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 8 ranks, the reference's (4, 2) FSDP run, the full-width dry-run
    cell and the one-process steps, at once."""
    out = tmp_path_factory.mktemp("fsdp")
    cfg = cfg_of("smollm-360m")
    params = lm.init(0, cfg, device="cpu")
    with open(out / "reference_in.pkl", "wb") as f:
        pickle.dump({"vocab": VOCAB, "batches": [
            {k: v for k, v in batch_of(cfg, s).items()}
            for s in range(STEPS)],
            "params": tree_map(lambda t: t.numpy(),
                               lm.to_reference_layout(params, cfg))}, f)
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out)],
            env=dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
                "--xla_force_host_platform_device_count=8")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "cell": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_CELL), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    logs = {}
    try:
        common = _COMMON.format(vocab=VOCAB, b=B, s=S, steps=STEPS)
        code = _RANKS.format(archs=repr(ARCHS), meshes=repr(MESHES),
                             common=common)
        spawn = {}

        def ranks():
            try:
                spawn["out"] = run_ranks(code, 8, out / "ranks",
                                         timeout=TIMEOUT)
            except AssertionError as e:     # handed to the test's thread
                spawn["err"] = e

        th = threading.Thread(target=ranks)
        th.start()
        one = {arch: _one_process(arch) for arch in ARCHS}
        th.join(TIMEOUT + 10)
        for name, p in procs.items():
            logs[name], _ = p.communicate(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not th.is_alive(), "the 8 ranks outlived their timeout"
    if "err" in spawn:
        raise spawn["err"]
    for name, p in procs.items():
        assert p.returncode == 0 and "OK" in logs[name], logs[name][-4000:]
    with open(out / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    with open(out / "cell.json") as f:
        cell = json.load(f)
    return {"out": out, "one": one, "reference": reference, "cell": cell}


def _rec(spawned, arch, mesh):
    return torch.load(spawned["out"] / "ranks" /
                      f"{arch}_{mesh[0]}x{mesh[1]}.pt")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_steps_match_one_process(spawned, arch, mesh):
    """3 steps: the loss, ``grad_norm``, and ``m``, ``v`` and the params
    leaf by leaf by name, after every step."""
    rtol, atol = BOUNDS[mesh]
    rec = _rec(spawned, arch, mesh)
    assert rec["split"] > 0
    for s, (got, want) in enumerate(zip(rec["steps"], spawned["one"][arch],
                                        strict=True)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       atol=atol, err_msg=f"{key} {s}")
        for k in ("params", "m", "v"):
            assert got[k].keys() == want[k].keys()
            for name, w in want[k].items():
                g = got[k][name]
                assert g.shape == w.shape, (k, name)
                assert torch.allclose(g, w, rtol=rtol, atol=atol), (
                    s, k, name, float((g - w).abs().max()))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_gathers_its_own_leaves(spawned, arch, mesh):
    """No whole ``model`` block of a stack leaf is gathered before the
    forward: every gather of one is inside a layer (the forward and the
    remat recompute), outside the layers only the embedding, the norms,
    the readout and the patch projection are gathered, and the gathered
    blocks live at once never exceed the largest layer's or those of the
    leaves outside the stack."""
    for step in _rec(spawned, arch, mesh)["steps"]:
        calls = step["calls"]
        inside = [(names, n) for names, layer, n in calls if layer]
        outside = [(names, n) for names, layer, n in calls if not layer]
        assert inside and outside
        for names, _ in inside:
            assert all("stack/" in n for n in names), names
        for names, _ in outside:
            assert all(n.startswith(OUTSIDE) for n in names), names
        # a layer gathers its leaves in one call (in the forward, and
        # again in its recompute)
        per_layer = max(n for _, n in inside)
        assert 0 < step["stack_peak"] <= per_layer
        assert step["peak"] <= max(per_layer, sum(n for _, n in outside))


def test_fsdp_step_matches_the_reference(spawned):
    """3 steps of reduced smollm-360m at vocab 512 on (4, 2) against the
    reference's jitted FSDP step on a (4, 2) Auto-axis mesh, from the same
    params and batches: the loss, ``grad_norm``, and every leaf of ``m``,
    ``v`` and the params in the reference's layout."""
    cfg = cfg_of("smollm-360m")
    rec = _rec(spawned, "smollm-360m", (4, 2))
    like = lm.init(0, cfg, device="cpu")
    names = names_of(like)
    for got, want in zip(rec["steps"], spawned["reference"], strict=True):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                       atol=2e-4)
        for k in ("params", "m", "v"):
            by_leaf = dict(zip(map(id, tree_leaves(like)),
                               (got[k][n] for n in names), strict=True))
            tree = tree_map(lambda t: by_leaf[id(t)], like)
            mine = ckpt.checkpoint._flatten(lm.to_reference_layout(tree, cfg))
            ref = ckpt.checkpoint._flatten(want[k])
            assert [p for p, _ in mine] == [p for p, _ in ref]
            for (path, a), (_, b) in zip(mine, ref, strict=True):
                np.testing.assert_allclose(a.numpy(), b, rtol=2e-3,
                                           atol=2e-4, err_msg=f"{k} {path}")


def test_fsdp_train_cell_is_ok(spawned):
    """The repair: full-width smollm-360m ``train_4k`` under ``--fsdp`` on
    the fake 16 x 16 world counts (before, AdamW raised on a gradient of
    the ``model`` block's whole size), its parameters gathered and their
    gradients reduce-scattered inside the layers."""
    rec = spawned["cell"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["kind"] == "train"
    cb = rec["roofline"]["coll_breakdown"]
    assert cb["reduce-scatter"] > 0 and cb["all-gather"] > 0
    assert cb["in_loop_count"] > 0


@pytest.mark.parametrize("arch", ("smollm-360m", "jamba-v0.1-52b"))
def test_one_rank_fsdp_step_is_the_one_device_step(one_rank_group, arch):
    """On a (1, 1) mesh inside ``tensor_parallel_at_one`` (the card's
    check) the state placed by ``state_shardings(..., fsdp=True)`` splits
    the parameters over the one-rank "data" axis and the step gathers
    them per layer with one-rank collectives: 2 steps bit-equal to the
    meshless step, as is the ZeRO-1 mesh step beside it."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import init_state
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    cfg = cfg_of(arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    params = model_for(cfg).init(0, cfg, device="cpu")
    plain = init_state(tree_map(lambda t: t.detach().clone(), params))
    gathers = []
    real = coll.gather_many

    def counting(xs, dims, share):
        gathers.append(len(xs))
        return real(xs, dims, share)

    with sh.tensor_parallel_at_one():
        states = {}
        for fsdp in (False, True):
            state = init_state(tree_map(lambda t: t.detach().clone(),
                                        params))
            with sh.use_mesh_rules(mesh):
                states[fsdp] = specs.place_state(state, specs.state_shardings(
                    cfg, state, mesh, fsdp=fsdp))
        assert not any(sh.gathered_axes(p) for p in
                       tree_leaves(states[False]["params"]))
        assert any(sh.gathered_axes(p) for p in
                   tree_leaves(states[True]["params"]))
        coll.gather_many = counting
        try:
            for s in range(2):
                batch = {k: torch.from_numpy(v)
                         for k, v in batch_of(cfg, s).items()}
                want = specs.make_train_step(cfg)(plain, batch)
                for fsdp, st in states.items():
                    n = len(gathers)
                    got = specs.make_train_step(cfg, mesh=mesh)(st, batch)
                    assert (len(gathers) > n) == fsdp
                    assert float(got["loss"]) == float(want["loss"])
                    for k in ("params", "m", "v"):
                        for a, b in zip(tree_leaves(st[k]),
                                        tree_leaves(plain[k]), strict=True):
                            assert torch.equal(sh.full(a), b), (fsdp, k)
        finally:
            coll.gather_many = real
