"""The port's ``parallel/`` against the reference's on the CPU: the
sharding rules, the BFP ring all-reduce and GPipe.

The reference runs in a subprocess with 8 forced host devices, as
``tests/test_parallel.py`` runs it, its meshes built as
``jax.sharding.Mesh(np.array(jax.devices()).reshape(...), names)`` (Auto
axes: ``jax.make_mesh``'s Explicit axes fail its ``constrain``, ROADMAP
Queue 3).  The port runs as 8 gloo ranks (``tests/_torch_ranks.py``) on
the same numpy inputs, made from the reference test's seed; both run at
once, and one spawn carries every multi-rank check.  The rules need no
process group: the port's specs are taken on a mesh shape.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _torch_ranks import ROOT, run_ranks
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro_torch.checkpoint.checkpoint import _flatten, _leaf_name
from repro_torch.configs import get_config
from repro_torch.models import encdec, lm, model_for
from repro_torch.parallel import collectives, pipeline
from repro_torch.parallel import sharding as sh

ARCHS = ["smollm-360m", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "mamba2-2.7b", "jamba-v0.1-52b", "whisper-tiny",
         "phi-3-vision-4.2b"]
MESH = {"data": 2, "model": 4}
# a min_size at which reduced jamba's linears quantize (the default 2**16
# leaves none at reduced widths)
BFP8_MIN_SIZE = 1024
TIMEOUT = 120

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpoint import _leaf_name
from repro.configs import get_config
from repro.core.bfp import quantize_linear_tree
from repro.models import model_for
from repro.parallel import sharding as sh
from repro.parallel.collectives import (bfp_psum, make_compressed_grad_sync,
                                        wire_bytes_ratio)
from repro.parallel.compat import shard_map
from repro.parallel.pipeline import bubble_fraction, pipeline_apply

OUT, ARCHS, MIN_SIZE = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
devs = np.array(jax.devices())
mesh24 = Mesh(devs.reshape(2, 4), ("data", "model"))

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {_leaf_name(p): [list(e) if isinstance(e, tuple) else e
                            for e in s.spec] for p, s in flat}

rules = {}
with sh.use_mesh_rules(mesh24, None):
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        init = lambda: model_for(cfg).init(jax.random.PRNGKey(0), cfg)
        abstract = jax.eval_shape(init)
        rules[arch] = {"param": specs(sh.param_shardings(abstract, mesh24)),
                       "zero1": specs(sh.zero1_shardings(abstract, mesh24))}
    cfg = get_config("jamba-v0.1-52b").reduced()
    q = jax.eval_shape(lambda: quantize_linear_tree(
        model_for(cfg).init(jax.random.PRNGKey(0), cfg), min_size=MIN_SIZE))
    rules["bfp8"] = specs(sh.param_shardings(q, mesh24))
    rules["divisibility"] = [
        list(sh.logical_sharding(shape, axes, mesh24).spec)
        for shape, axes in [((16, 8), (None, "heads")),
                            ((16, 5), (None, "heads")),
                            ((8, 8), ("heads", "mlp"))]]
mesh222 = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
rules["batch"] = {
    "pod": [list(e) if isinstance(e, tuple) else e
            for e in sh.batch_sharding(mesh222, 3).spec],
    "data": list(sh.batch_sharding(mesh24, 2).spec)}
rules["wire"] = [wire_bytes_ratio(), wire_bytes_ratio(bits=16),
                 wire_bytes_ratio(block=64, baseline_bytes=4)]
rules["bubble"] = [bubble_fraction(8, 4), bubble_fraction(1, 2)]
with open(OUT + "/rules.json", "w") as f:
    json.dump(rules, f)

# the reference test's inputs, in its order
rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((8, 2048)), jnp.float32)
ws = jnp.asarray(rng.standard_normal((4, 16, 16)) * 0.3, jnp.float32)
xs = jnp.asarray(rng.standard_normal((8, 2, 16)), jnp.float32)
mesh8 = Mesh(devs, ("data",))

def psum(bits):
    return np.asarray(jax.jit(shard_map(
        lambda v: bfp_psum(v[0], "data", bits=bits), mesh=mesh8,
        in_specs=P("data"), out_specs=P(None), check_vma=False))(x))

def exp2(v):
    v = jnp.asarray(v)
    return jnp.ldexp(jnp.ones(v.shape, jnp.float32),
                     jnp.round(v).astype(jnp.int32))

grads = {"big": x[0].reshape(64, 32), "small": x[1, :10],
         "odd": x[2, :1030]}
out = {f"unpatched{b}": psum(b) for b in (8, 16)}
jax.clear_caches()
exp2_xla, jnp.exp2 = jnp.exp2, exp2
out.update({f"patched{b}": psum(b) for b in (8, 16)})
sync = jax.jit(make_compressed_grad_sync(mesh8))(grads)
out.update({f"sync_{k}": np.asarray(v) for k, v in sync.items()})
jnp.exp2 = exp2_xla
jax.clear_caches()
mesh42 = Mesh(devs.reshape(4, 2), ("pipe", "data"))
out["pipeline"] = np.asarray(jax.jit(lambda w, v: pipeline_apply(
    lambda a, b: jnp.tanh(b @ a), w, v, mesh=mesh42, axis="pipe"))(ws, xs))
np.savez(OUT + "/reference.npz", **out)
print("OK")
"""

_RANKS = """
import numpy as np
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.collectives import (
    all_reduce_coalesced, bfp_psum, make_compressed_grad_sync)
from repro_torch.parallel.pipeline import pipeline_apply

rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((8, 2048)).astype(np.float32))
ws = torch.from_numpy((rng.standard_normal((4, 16, 16)) * 0.3)
                      .astype(np.float32))
xs = torch.from_numpy(rng.standard_normal((8, 2, 16)).astype(np.float32))
mesh8 = make_mesh((8,), ("data",))
group = mesh8.get_group("data")
out = {f"psum{b}": bfp_psum(x[RANK], group, bits=b).numpy()
       for b in (8, 16)}
sync = make_compressed_grad_sync(mesh8)
# the reference's usage: every rank's grads alike
same = sync({"big": x[0].reshape(64, 32), "small": x[1, :10],
             "odd": x[2, :1030]})
out.update({f"sync_{k}": v.numpy() for k, v in same.items()})
# each rank's own: the mean over the ranks
own = sync({"big": x[RANK].reshape(64, 32), "small": [x[RANK, :10]]})
out["own_big"], out["own_small"] = own["big"].numpy(), own["small"][0].numpy()
# coalesced sums: two dtypes, a transposed view, one over the cap
ts = [x[RANK, :10].clone(), x[RANK, 10:16].double(),
      x[RANK, 16:28].reshape(3, 4).t(), x[RANK, 28:2028].clone(),
      x[RANK, 2028:2040].clone()]
all_reduce_coalesced(ts, [group], cap=1024)
out["coalesced"] = np.concatenate([t.reshape(-1).float().numpy()
                                   for t in ts])
mesh42 = make_mesh((4, 2), ("pipe", "data"))
out["pipeline"] = pipeline_apply(lambda w, v: torch.tanh(v @ w), ws, xs,
                                 mesh=mesh42, axis="pipe").numpy()
np.savez(f"{OUT}/rank{RANK}.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 8 gloo ranks, at once."""
    out = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
         json.dumps(ARCHS), str(BFP8_MIN_SIZE)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks(_RANKS, 8, out / "ranks", timeout=TIMEOUT)
        log, _ = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in log, log[-4000:]
    with open(out / "rules.json") as f:
        rules = json.load(f)
    return {"rules": rules,
            "ref": dict(np.load(out / "reference.npz")),
            "ranks": [dict(np.load(out / "ranks" / f"rank{r}.npz"))
                      for r in range(8)]}


# --- the sharding rules ----------------------------------------------------
def _json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _named(tree):
    """{leaf name: spec as the reference's JSON}, the checkpoint's names."""
    return {_leaf_name(p): _json(s.spec) for p, s in _flatten(tree)}


def _reference_layout(arch, params):
    cfg = get_config(arch).reduced()
    return model_for(cfg).to_reference_layout(params, cfg)


def _stacks(cfg):
    """(key, the stack's config) of each layer stack of the family."""
    if model_for(cfg) is encdec:
        return [("enc_stack", encdec.enc_cfg(cfg)), ("dec_stack", cfg)]
    return [("stack", cfg)]


def _reference_path(path, cfg):
    """The reference layout's path of the port's leaf at ``path`` and
    whether it gains the leading layers dim there."""
    for key, c in _stacks(cfg):
        if path[0] == key:
            i = path[1]
            n_prefix = lm._n_prefix(c)
            if i < n_prefix:
                return (key, "prefix", i) + path[2:], False
            j = (i - n_prefix) % c.pattern_period()
            return (key, "scan", f"b{j}") + path[2:], True
    return path, False


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(runs, arch):
    """On a (2, 4) ("data", "model") mesh every leaf's spec is the
    reference's, for the port's tree laid out as the reference's (its
    layers stacked), under ``param_shardings`` and ``zero1_shardings``;
    each of the port's per-layer leaves has its stacked leaf's spec
    without the layers entry."""
    cfg = get_config(arch).reduced()
    params = model_for(cfg).init(0, cfg, device="cpu")
    ref_layout = _reference_layout(arch, params)
    want = runs["rules"][arch]
    got = _named(sh.param_shardings(ref_layout, MESH))
    assert got == want["param"]
    assert _named(sh.zero1_shardings(ref_layout, MESH)) == want["zero1"]
    assert any(s != [None] * len(s) for s in got.values())
    stacked = {p: s.spec for p, s in _flatten(
        sh.param_shardings(ref_layout, MESH))}
    for path, s in _flatten(sh.param_shardings(params, MESH)):
        ref_path, layered = _reference_path(path, cfg)
        ref_spec = stacked[ref_path]
        assert tuple(s.spec) == (ref_spec[1:] if layered else ref_spec), path


def test_bfp8_leaf_specs_equal_the_reference(runs):
    """Reduced jamba's BFP-compressed tree (``w_q`` / ``w_e`` leaves): the
    w_q block dim unsharded, w_e as its w."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    q = lm.quantize_linear_tree(lm.init(0, cfg, device="cpu"), cfg,
                                min_size=BFP8_MIN_SIZE)
    got = _named(sh.param_shardings(lm.to_reference_layout(q, cfg), MESH))
    assert got == runs["rules"]["bfp8"]
    assert any(k.endswith("w_q") for k in got) and \
        any(k.endswith("w_e") for k in got)


def test_sharding_rules_divisibility(runs):
    """The reference test's three cases, and the batch rule on a
    ("pod", "data", "model") mesh."""
    with sh.use_mesh_rules(MESH, None):
        s = sh.logical_sharding((16, 8), (None, "heads"), MESH)
        assert s.spec == sh.P(None, "model"), s.spec
        s2 = sh.logical_sharding((16, 5), (None, "heads"), MESH)
        assert s2.spec == sh.P(None, None), s2.spec
        s3 = sh.logical_sharding((8, 8), ("heads", "mlp"), MESH)
        assert list(s3.spec).count("model") == 1, s3.spec
        assert [_json(x.spec) for x in (s, s2, s3)] == \
            runs["rules"]["divisibility"]
    pod = {"pod": 2, "data": 2, "model": 2}
    assert _json(sh.batch_sharding(pod, 3).spec) == \
        runs["rules"]["batch"]["pod"]
    assert _json(sh.batch_sharding(MESH, 2).spec) == \
        runs["rules"]["batch"]["data"]
    # DTensor placements: ("pod", "data") shards dim 0 on both, in mesh
    # order; another order is refused
    from torch.distributed.tensor import Replicate, Shard
    assert sh.batch_sharding(pod, 3).placements == (Shard(0), Shard(0),
                                                    Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        sh.P(("data", "pod")).placements(pod)
    assert sh.replicated_sharding(MESH).spec == sh.P()
    # constrain: no mesh, or a plain tensor, passes through; the rank is
    # checked against the axes
    x = torch.zeros(16, 8)
    assert sh.constrain(x, ("batch", "heads")) is x
    with sh.use_mesh_rules(MESH, None):
        assert sh.constrain(x, ("batch", "heads")) is x
        with pytest.raises(ValueError, match="rank"):
            sh.constrain(x, ("batch",))
    assert [collectives.wire_bytes_ratio(),
            collectives.wire_bytes_ratio(bits=16),
            collectives.wire_bytes_ratio(block=64, baseline_bytes=4)] == \
        runs["rules"]["wire"]


# --- the BFP ring all-reduce -------------------------------------------------
@pytest.mark.parametrize("bits", [8, 16])
def test_bfp_psum_matches_the_reference(runs, bits):
    """On 8 gloo ranks: every rank's sum bit-equal to the reference's
    ``shard_map`` result under an exact ``exp2``, within one quantization
    step of the unpatched one, and within the reference test's bound of
    the exact sum (0.05 at 8 bits, 3e-4 at 16, relative to max|sum|)."""
    ref = runs["ref"]
    x = np.random.default_rng(0).standard_normal((8, 2048)).astype(
        np.float32)
    exact = x.sum(0)
    amax = float(np.abs(exact).max())
    step = 2.0 ** (np.ceil(np.log2(amax)) - (bits - 1))
    for got in (r[f"psum{bits}"] for r in runs["ranks"]):
        assert np.array_equal(got, ref[f"patched{bits}"])
        assert float(np.abs(got - ref[f"unpatched{bits}"]).max()) <= step
        rel = float(np.abs(got - exact).max()) / amax
        assert rel < (0.05 if bits == 8 else 3e-4), rel


def test_compressed_grad_sync_matches_the_reference(runs):
    """``make_compressed_grad_sync`` over a tree mixing a compressed leaf
    (2,048 elements), one under ``min_size`` and one whose size does not
    divide by the block: with every rank's grads alike (the reference's
    usage) each leaf bit-equal to the reference's under an exact
    ``exp2``; with each rank's own, the large leaf the BFP ring's sum / 8
    and the small one the exact mean."""
    ref = runs["ref"]
    x = np.random.default_rng(0).standard_normal((8, 2048)).astype(
        np.float32)
    for r in runs["ranks"]:
        for k in ("big", "small", "odd"):
            assert np.array_equal(r[f"sync_{k}"], ref[f"sync_{k}"]), k
        assert np.array_equal(r["own_big"],
                              (ref["patched8"] / 8).reshape(64, 32))
        np.testing.assert_allclose(r["own_small"], x[:, :10].mean(0),
                                   rtol=1e-6, atol=1e-6)


def test_all_reduce_coalesced_sums_every_tensor(runs):
    """One all-reduce a bucket of one dtype under the cap: every tensor
    (f32 and f64, a transposed view, one larger than the cap alone) holds
    the sum over the 8 ranks, alike on every rank."""
    x = np.random.default_rng(0).standard_normal((8, 2048)).astype(
        np.float32)
    s = x.sum(0)
    want = np.concatenate([s[:10], x[:, 10:16].astype(np.float64).sum(0),
                           s[16:28].reshape(3, 4).T.reshape(-1),
                           s[28:2040]]).astype(np.float32)
    got = [r["coalesced"] for r in runs["ranks"]]
    assert all(np.array_equal(g, got[0]) for g in got)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


# --- GPipe ------------------------------------------------------------------
def test_pipeline_apply_matches_the_reference(runs):
    """On a (4, 2) ("pipe", "data") mesh with the reference test's
    ``tanh(x @ w)`` stages: every rank's output within 1e-5 of the
    reference's and of the sequential loop; ``bubble_fraction`` equal."""
    rng = np.random.default_rng(0)
    rng.standard_normal((8, 2048))
    ws = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((8, 2, 16)).astype(np.float32)
    seq = torch.from_numpy(xs)
    for s in range(4):
        seq = torch.tanh(seq @ torch.from_numpy(ws[s]))
    for r in runs["ranks"]:
        assert float(np.abs(r["pipeline"] - runs["ref"]["pipeline"]).max()) \
            < 1e-5
        assert float(np.abs(r["pipeline"] - seq.numpy()).max()) < 1e-5
    assert [pipeline.bubble_fraction(8, 4), pipeline.bubble_fraction(1, 2)] \
        == runs["rules"]["bubble"]
