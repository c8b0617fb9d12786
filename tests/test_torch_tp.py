"""Tensor-parallel compute over ``model`` on gloo ranks on the CPU.

One spawn of 8 ranks builds three ("data", "model") meshes in turn: (4, 2)
(head-parallel, the reduced KV 2 split), (2, 4) (head-parallel, KV 2 not
split: K/V gathered by columns) and (1, 8) (4 heads over 8: q split along
the sequence, K/V whole).  On each, seven reduced archs with
``vocab_size`` 512 (so that the vocabulary splits) take a training step
(``runtime/trainer.py::mesh_grads`` and AdamW) and a prefill + two decode
steps at per-slot lengths, held to the port's one-process step within the
reference test's bound, rtol 2e-3 / atol 2e-4: the loss, every gradient
leaf by name, the updated params, the logits and next tokens.  The ranks
count every whole gather of a parameter (``DTensor.full_tensor`` and
``collectives.gather`` of a parameter's block): none on the head-parallel
meshes; on (1, 8) only the attention weights, the sequence-parallel
regime's one exception.  The (1, 8) mesh also runs 3 ``Trainer`` steps of
reduced smollm-360m at vocab 512, held to the reference's ``Trainer`` on
a (1, 8) Auto-axis mesh of 8 forced host devices (a subprocess, as
``tests/test_torch_mesh_train.py`` runs it).  Kernel 5's lse mode is held
on the CPU without ranks: blocks merged equal the whole cache, and an
empty block gives -inf and 0.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch
from _torch_ranks import ROOT, one_rank_group, run_ranks  # noqa: F401
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro_torch import checkpoint as ckpt
from repro_torch.kernels.decode_attn.ref import (decode_attention_ref,
                                                  merge_blocks)
from repro_torch.models import lm, model_for
from repro_torch.nn.module import tree_leaves, tree_map_with_path
from repro_torch.optim import adamw_step, init_state
from repro_torch.parallel import sharding as sh
from repro_torch.runtime import Trainer, TrainerConfig

RTOL, ATOL = 2e-3, 2e-4          # the reference test's bound
ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "mamba2-2.7b", "jamba-v0.1-52b", "whisper-tiny",
         "phi-3-vision-4.2b")
MESHES = ((4, 2), (2, 4), (1, 8))
VOCAB = 512
B, S, L, DECODES = 4, 16, 32, 2
BACK = (0, 3, 5, 8)              # each slot's decode starts S - BACK back
TC = dict(steps=3, batch=4, seq_len=32, base_lr=1e-3, log_every=1)
LR = 1e-3
TIMEOUT = 150
# served on BFP-compressed weights too (every leaf of 1,024 elements or
# more compressed: the reduced widths' linears and experts)
BFP_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b",
             "jamba-v0.1-52b")
BFP_MIN = 1024

_COMMON = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config

VOCAB, B, S, L, DECODES, BACK = {vocab}, {b}, {s}, {l}, {dec}, {back}


def cfg_of(arch):
    return dataclasses.replace(get_config(arch).reduced(), vocab_size=VOCAB)


def batch_of(cfg):
    g = np.random.default_rng(7)
    b = {{"inputs": torch.from_numpy(g.integers(0, VOCAB, (B, S))),
          "targets": torch.from_numpy(g.integers(-1, VOCAB, (B, S)))}}
    if cfg.family == "audio":
        b["frames"] = torch.from_numpy(
            g.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        b["patches"] = torch.from_numpy(
            g.standard_normal((B, cfg.num_patches, 1024)).astype(np.float32))
    return b


def lengths_of(cfg, t):
    off = cfg.num_patches if cfg.family == "vlm" else 0
    return torch.tensor([off + S - k + t for k in BACK])
"""

_RANKS = """
import pickle
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm, model_for
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.optim import adamw_step, init_state
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime.trainer import mesh_grads
from torch.distributed.tensor import DTensor

ARCHS, MESHES, TC = {archs}, {meshes}, {tc}
BFP_ARCHS, BFP_MIN = {bfp_archs}, {bfp_min}
{common}
gathered, full_calls = [], [0]
real_gather, real_full = coll.gather, DTensor.full_tensor


def counting_gather(x, dim, share):
    name = OWNERS.get(x.data_ptr()) if x.is_leaf else None
    if name is not None:
        gathered.append(name)
    return real_gather(x, dim, share)


def counting_full(self, *a, **k):
    full_calls[0] += 1
    return real_full(self, *a, **k)


coll.gather = counting_gather
DTensor.full_tensor = counting_full
OWNERS = {{}}


def whole(t, like):
    if tuple(t.shape) == tuple(like.shape):
        return t.detach()
    return real_full(DTensor.from_local(
        t.detach(), like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride()))


def names_of(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in names_of(tree[k], f"{{path}}/{{k}}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in names_of(v, f"{{path}}/{{i}}")]
    return [path]


# a prefill and DECODES decode steps of this rank's slots on caches placed
# by cache_shardings: the logits (gathered over the vocabulary) and the
# next tokens
def serve(cfg, mod, blocks, mesh):
    batch = batch_of(cfg)
    with sh.use_mesh_rules(mesh):
        vshare = lm.vocab_share(cfg)
        index, count = sh.batch_share(mesh)
    kw = {{"cross_len": S}} if cfg.family == "audio" else {{}}
    caches = lm.zero_caches(mod.cache_shape(cfg, B, L, **kw), "cpu")
    caches = sh.place_tree(caches, specs.cache_shardings(cfg, caches, mesh))
    n = B // count
    rows = slice(index * n, (index + 1) * n)
    ex = {{k: batch[k][rows] for k in ("frames", "patches") if k in batch}}
    logits, toks = [], []
    with torch.no_grad(), sh.use_mesh_rules(mesh):
        lg, _, _ = mod.apply(blocks, cfg, batch["inputs"][rows],
                             mode="prefill", caches=caches, **ex)
        logits.append(lg)
        toks.append(lm.greedy(lg[:, -1], vshare))
        for t in range(DECODES):
            lg, _, _ = mod.apply(blocks, cfg, toks[-1][:, None].long(),
                                 mode="decode", caches=caches,
                                 length=lengths_of(cfg, t)[rows])
            logits.append(lg)
            toks.append(lm.greedy(lg[:, -1], vshare))
        if vshare is not None:
            logits = [coll.gather_nograd(x, -1, vshare) for x in logits]
    return {{"logits": logits, "toks": toks, "rows": (index, n)}}


for shape in MESHES:
    mesh = make_mesh(tuple(shape), ("data", "model"))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for arch in ARCHS:
        cfg = cfg_of(arch)
        mod = model_for(cfg)
        params = mod.init(0, cfg, device="cpu")
        names = names_of(params)
        with sh.use_mesh_rules(mesh):
            placed = sh.place_tree(params, sh.param_shardings(params, mesh))
            vshare = lm.vocab_share(cfg)
        batch = batch_of(cfg)
        OWNERS.clear()
        OWNERS.update({{sh.local(p).data_ptr(): n for n, p in
                        zip(names, tree_leaves(placed))}})
        del gathered[:]
        full_calls[0] = 0
        grads, met = mesh_grads(mod, cfg, placed, batch, mesh)
        st = init_state(placed)
        adamw_step(st, grads, lr={lr}, weight_decay=0.01, clip_norm=1.0)
        rec = {{"grads": {{n: whole(g, p) for n, g, p in
                          zip(names, grads, tree_leaves(placed))}},
               "params": {{n: real_full(p) if sh.is_dtensor(p) else p
                           for n, p in zip(names, tree_leaves(st["params"]))}},
               "loss": float(met["loss"]), "aux": float(met["aux_loss"])}}
        train_gathers, train_full = sorted(set(gathered)), full_calls[0]
        # serve (AdamW updated ``placed`` in place: placed again): a
        # prefill and DECODES decode steps on the placed caches
        with sh.use_mesh_rules(mesh):
            placed = sh.place_tree(params, sh.param_shardings(params, mesh))
        blocks = tree_map(sh.model_block, placed)
        OWNERS.clear()
        OWNERS.update({{sh.local(p).data_ptr(): n for n, p in
                        zip(names, tree_leaves(placed))}})
        del gathered[:]
        full_calls[0] = 0
        rec.update(serve(cfg, mod, blocks, mesh))
        rec.update(train_gathers=train_gathers, train_full=train_full,
                   serve_gathers=sorted(set(gathered)),
                   serve_full=full_calls[0])
        if coord["model"] == 0:
            torch.save(rec, f"{{OUT}}/{{arch}}_{{shape[0]}}x{{shape[1]}}"
                            f"_d{{coord['data']}}.pt")
    for arch in BFP_ARCHS:
        # the serve steps on BFP-compressed weights (each rank dequantizes
        # its block of a compressed leaf)
        cfg = cfg_of(arch)
        mod = model_for(cfg)
        params = lm.quantize_linear_tree(mod.init(0, cfg, device="cpu"), cfg,
                                         min_size=BFP_MIN)
        with sh.use_mesh_rules(mesh):
            placed = sh.place_tree(params, sh.param_shardings(params, mesh))
        rec = serve(cfg, mod, tree_map(sh.model_block, placed), mesh)
        if coord["model"] == 0:
            torch.save(rec, f"{{OUT}}/{{arch}}_bfp8_{{shape[0]}}x{{shape[1]}}"
                            f"_d{{coord['data']}}.pt")
    if tuple(shape) == (1, 8):
        # the Trainer against the reference's (1, 8) run
        coll.gather, DTensor.full_tensor = real_gather, real_full
        cfg = cfg_of("smollm-360m")
        with open(OUT + "/init.pkl", "rb") as f:
            init = pickle.load(f)
        tr = Trainer(cfg, TrainerConfig(**TC), mesh=mesh, device="cpu",
                     params=lm.params_from_reference(init, cfg,
                                                     device="cpu"))
        tr.run()
        final = [sh.full(t).detach() for t in tree_leaves(tr.state["params"])]
        if RANK == 0:
            torch.save({{"params": final,
                         "losses": [h["loss"] for h in tr.history]}},
                       OUT + "/trainer_1x8.pt")
"""

_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.runtime import Trainer, TrainerConfig
out, tc, vocab = sys.argv[1], eval(sys.argv[2]), int(sys.argv[3])
with open(out + "/init.pkl", "rb") as f:
    params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
mesh = Mesh(np.array(jax.devices()).reshape(1, 8), ("data", "model"))
cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                          vocab_size=vocab)
tr = Trainer(cfg, TrainerConfig(**tc), mesh=mesh, params=params)
tr.run()
with open(out + "/reference.pkl", "wb") as f:
    pickle.dump({"params": jax.tree_util.tree_map(np.asarray,
                                                  tr.state["params"]),
                 "losses": [h["loss"] for h in tr.history]}, f)
print("OK")
"""

exec(_COMMON.format(vocab=VOCAB, b=B, s=S, l=L, dec=DECODES, back=BACK))


def _names(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], f"{path}/{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{path}/{i}")]
    return [path]


def _serve_one(cfg, mod, params):
    """The one-process prefill and decodes: logits and next tokens."""
    batch = batch_of(cfg)
    kw = {"cross_len": S} if cfg.family == "audio" else {}
    caches = lm.zero_caches(mod.cache_shape(cfg, B, L, **kw), "cpu")
    ex = {k: batch[k] for k in ("frames", "patches") if k in batch}
    logits, toks = [], []
    with torch.no_grad():
        lg, _, _ = mod.apply(params, cfg, batch["inputs"], mode="prefill",
                             caches=caches, **ex)
        logits.append(lg)
        toks.append(lg[:, -1].argmax(-1))
        for t in range(DECODES):
            lg, _, _ = mod.apply(params, cfg, toks[-1][:, None],
                                 mode="decode", caches=caches,
                                 length=lengths_of(cfg, t))
            logits.append(lg)
            toks.append(lg[:, -1].argmax(-1))
    return {"logits": logits, "toks": toks}


def _one_process(arch):
    """The port's one-process step: the loss, every gradient by name, the
    AdamW update, and the logits and tokens of the prefill and decodes
    (of BFP-compressed weights too, for ``BFP_ARCHS``)."""
    cfg = cfg_of(arch)
    mod = model_for(cfg)
    params = mod.init(0, cfg, device="cpu")
    names = _names(params)
    batch = batch_of(cfg)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, met = mod.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    st = init_state(tree_map_with_path(lambda _, t: t.detach().clone(),
                                       params))
    adamw_step(st, list(grads), lr=LR, weight_decay=0.01, clip_norm=1.0)
    out = {"loss": float(met["loss"].detach()),
           "aux": float(met["aux_loss"].detach()),
           "grads": dict(zip(names, grads)),
           "params": dict(zip(names, tree_leaves(st["params"]))),
           **_serve_one(cfg, mod, params)}
    if arch in BFP_ARCHS:
        q = lm.quantize_linear_tree(mod.init(0, cfg, device="cpu"), cfg,
                                    min_size=BFP_MIN)
        out["bfp8"] = _serve_one(cfg, mod, q)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 8 ranks, the reference's (1, 8) run and the one-process steps,
    at once."""
    out = tmp_path_factory.mktemp("tp")
    j_cfg = dataclasses.replace(j_get_config("smollm-360m").reduced(),
                                vocab_size=VOCAB)
    init = jax.tree_util.tree_map(
        np.asarray, j_lm.init(jax.random.PRNGKey(0), j_cfg))
    with open(out / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
         repr(TC), str(VOCAB)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        common = _COMMON.format(vocab=VOCAB, b=B, s=S, l=L, dec=DECODES,
                                back=BACK)
        code = _RANKS.format(archs=repr(ARCHS), meshes=repr(MESHES),
                             tc=repr(TC), common=common, lr=LR,
                             bfp_archs=repr(BFP_ARCHS), bfp_min=BFP_MIN)
        spawn = {}

        def ranks():
            try:
                spawn["out"] = run_ranks(code, 8, out, timeout=TIMEOUT)
            except AssertionError as e:     # handed to the test's thread
                spawn["err"] = e

        th = threading.Thread(target=ranks)
        th.start()
        one = {arch: _one_process(arch) for arch in ARCHS}
        cfg = cfg_of("smollm-360m")
        tr = Trainer(cfg, TrainerConfig(**TC), device="cpu",
                     params=lm.params_from_reference(init, cfg,
                                                     device="cpu"))
        tr.run()
        th.join(TIMEOUT + 10)
        log, _ = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert not th.is_alive(), "the 8 ranks outlived their timeout"
    if "err" in spawn:
        raise spawn["err"]
    assert ref.returncode == 0 and "OK" in log, log[-4000:]
    with open(out / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    return {"out": out, "one": one, "reference": reference,
            "trainer_one": tr}


def _recs(spawned, arch, mesh):
    data = mesh[0]
    return [torch.load(spawned["out"] / f"{arch}_{mesh[0]}x{mesh[1]}_d{d}.pt")
            for d in range(data)]


def _close(got, want, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.allclose(got, want, rtol=RTOL, atol=ATOL), (
        what, float((got - want).abs().max()))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_one_process(spawned, arch, mesh):
    """The loss, every gradient leaf by name (a replicated leaf summed
    over ``model`` once: the router, the norms, Mamba's in-projections,
    ``wdkv``, an untied ``lm_head``) and the params after AdamW."""
    one = spawned["one"][arch]
    rec = _recs(spawned, arch, mesh)[0]
    np.testing.assert_allclose(rec["loss"], one["loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rec["aux"], one["aux"], rtol=RTOL, atol=ATOL)
    assert rec["grads"].keys() == one["grads"].keys()
    for name, g in one["grads"].items():
        _close(rec["grads"][name], g, f"grad {name}")
    for name, p in one["params"].items():
        got, g = rec["params"][name].float(), one["grads"][name].float()
        # AdamW's first step moves an element by about lr whatever its
        # gradient's size: where the gradient is float noise (under ATOL
        # on both sides) its sign, and so the step, is the summation
        # order's, and the element is held to 2 lr
        noise = (g.abs() < ATOL) & (rec["grads"][name].float().abs() < ATOL)
        within = torch.isclose(got, p.float(), rtol=RTOL, atol=ATOL) | (
            noise & ((got - p.float()).abs() <= 2 * LR))
        assert within.all(), (name, float((got - p.float()).abs().max()))


def _serve_case(spawned, arch, mesh, tag=""):
    one = spawned["one"][arch]
    one = one[tag] if tag else one
    recs = _recs(spawned, f"{arch}_{tag}" if tag else arch, mesh)
    for rec in recs:
        index, n = rec["rows"]
        rows = slice(index * n, (index + 1) * n)
        for i, (got, want) in enumerate(zip(rec["logits"], one["logits"],
                                            strict=True)):
            _close(got, want[rows], f"logits {i}")
        for i, (got, want) in enumerate(zip(rec["toks"], one["toks"],
                                            strict=True)):
            assert torch.equal(got.long(), want[rows]), f"tokens {i}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_one_process(spawned, arch, mesh):
    """The prefill's and two decodes' logits (each rank's slots, gathered
    over the vocabulary) and next tokens (the argmax across the ranks'
    blocks of the vocabulary)."""
    _serve_case(spawned, arch, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", BFP_ARCHS)
def test_serve_steps_on_bfp8_weights(spawned, arch, mesh):
    """The same on ``quantize_linear_tree``'s weights (the experts, MLA's
    up-projections, the MLP rows and columns): each rank dequantizes its
    block of a compressed leaf."""
    _serve_case(spawned, arch, mesh, "bfp8")


def test_no_parameter_is_gathered_whole(spawned):
    """No step calls ``full_tensor``; on the head-parallel meshes no
    parameter's block is gathered; on (1, 8), where 4 heads do not split
    8 ways, only the attention weights are (the sequence-parallel
    regime)."""
    for arch in ARCHS:
        for mesh in MESHES:
            for rec in _recs(spawned, arch, mesh):
                assert rec["train_full"] == 0 and rec["serve_full"] == 0
                moved = rec["train_gathers"] + rec["serve_gathers"]
                if mesh[1] in (2, 4):
                    assert moved == [], (arch, mesh, moved)
                else:
                    assert all("attn/" in n for n in moved), (arch, moved)
    # the regime is the one the test means: (1, 8) gathers wq
    rec = _recs(spawned, "smollm-360m", (1, 8))[0]
    assert "stack/0/attn/wq/w" in rec["train_gathers"]


def test_trainer_1x8_matches_the_reference_and_one_process(spawned):
    """3 ``Trainer`` steps of reduced smollm-360m at vocab 512 on the
    (1, 8) mesh (sequence-parallel attention, the vocabulary split 8
    ways) against the reference's (1, 8) Auto-axis run from the same
    params, and against the port's one-process run."""
    cfg = cfg_of("smollm-360m")
    got = torch.load(spawned["out"] / "trainer_1x8.pt")
    ref = spawned["reference"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                               atol=ATOL)
    like = lm.init(0, cfg, device="cpu")
    by_leaf = dict(zip(map(id, tree_leaves(like)), got["params"],
                       strict=True))
    tree = tree_map_with_path(lambda _, t: by_leaf[id(t)], like)
    mine = [t.numpy() for _, t in ckpt.checkpoint._flatten(
        lm.to_reference_layout(tree, cfg))]
    want = [a for _, a in ckpt.checkpoint._flatten(ref["params"])]
    worst = 0.0
    for a, b in zip(mine, want, strict=True):
        worst = max(worst, float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    print(f"(1, 8) port vs reference: max|diff| {worst:.3e}")
    one = spawned["trainer_one"]
    for a, b in zip(got["params"], tree_leaves(one.state["params"]),
                    strict=True):
        _close(a, b, "trainer params")


# --- one rank -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_the_one_device_step(one_rank_group, arch):
    """On a (1, 1) mesh the ``Trainer`` takes the one-device step (no
    ``model`` share); inside ``tensor_parallel_at_one`` it runs the
    tensor-parallel layers, whose one-rank collectives move nothing: 2
    steps with remat, both bit-equal to the meshless ``Trainer``."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    assert sh.model_share(mesh) is None
    cfg = dataclasses.replace(cfg_of(arch), remat=True)
    tc = TrainerConfig(steps=2, batch=2, seq_len=16, base_lr=1e-3,
                       log_every=1)
    plain = Trainer(cfg, tc, device="cpu")
    plain.run()
    with sh.tensor_parallel_at_one():
        assert sh.model_share(mesh).size == 1
        tp = Trainer(cfg, tc, mesh=mesh, device="cpu")
        tp.run()
    one = Trainer(cfg, tc, mesh=mesh, device="cpu")
    one.run()
    for tr in (tp, one):
        assert [h["loss"] for h in tr.history] == [
            h["loss"] for h in plain.history]
        for a, b in zip(tree_leaves(tr.state["params"]),
                        tree_leaves(plain.state["params"]), strict=True):
            assert torch.equal(sh.full(a), b)


# --- kernel 5's lse mode, on the CPU -------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_decode_blocks_merge_to_the_whole_cache(dtype, blocks):
    """A cache of 64 rows in ``blocks`` blocks, each attended with the
    lse at its local length clamp(length - r x block, 0, block): merged,
    the whole cache's output and lse (lengths 1-64, whole blocks empty
    among them)."""
    g = torch.Generator().manual_seed(blocks)
    Bq, Lc, H, KV, D = 6, 64, 6, 2, 16
    q = torch.randn(Bq, 1, H, D, generator=g).to(dtype)
    k = torch.randn(Bq, Lc, KV, D, generator=g).to(dtype)
    v = torch.randn(Bq, Lc, KV, D, generator=g).to(dtype)
    lengths = torch.tensor([1, 5, 17, 32, 40, 64])
    o, lse = decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert torch.equal(o, decode_attention_ref(q, k, v, lengths))
    Lb = Lc // blocks
    parts = [decode_attention_ref(q, k[:, r * Lb:(r + 1) * Lb],
                                  v[:, r * Lb:(r + 1) * Lb],
                                  (lengths - r * Lb).clamp(0, Lb),
                                  return_lse=True) for r in range(blocks)]
    mo, mlse = merge_blocks(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert mo.dtype == dtype
    torch.testing.assert_close(mo.float(), o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mlse, lse, rtol=1e-5, atol=1e-5)


def test_decode_empty_block_gives_minus_inf_and_zero():
    """A slot of length 0 in the lse mode: output 0 and lse -inf (without
    the lse it attends uniformly, the mean of v); merging an empty block
    changes nothing, and every block empty gives 0."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1, 4, 8, generator=g)
    k = torch.randn(2, 16, 2, 8, generator=g)
    v = torch.randn(2, 16, 2, 8, generator=g)
    lengths = torch.tensor([0, 9])
    o, lse = decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1]).all()
    uniform = decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(uniform[0, 0, :2],
                               v[0].mean(0).expand(2, 2, 8)[:, 0])
    mo, mlse = merge_blocks(torch.stack([o, o * 0]),
                            torch.stack([lse, torch.full_like(lse,
                                                              -torch.inf)]))
    assert torch.equal(mo[1], o[1]) and torch.equal(mlse[1], lse[1])
    assert torch.equal(mo[0], torch.zeros_like(mo[0]))
    assert torch.isneginf(mlse[0]).all()
