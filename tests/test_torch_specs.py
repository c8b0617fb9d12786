"""The port's ``launch/specs.py`` against the reference's at full width:
every stand-in's shapes and dtypes and every placement, and the dry run's
wire-byte rule against the reference's HLO parser.

The reference runs once, in a subprocess with 512 forced host devices
(its 16x16 and 2x16x16 meshes built as ``jax.sharding.Mesh`` over them,
Auto axes, as ``tests/test_torch_parallel.py`` builds its meshes): its
``eval_shape`` stand-ins for every arch of ``LM_ARCHS`` and every
applicable shape of ``SHAPES``, its ``PartitionSpec``s, and
``_line_wire_bytes`` on synthesized collective lines.  The port's
stand-ins are meta tensors, taken in its own layout (a layer list) and
compared in the reference's (``to_reference_layout`` stacks the layers);
its rules run on mesh shapes (no process group).  Exact equality
throughout.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from _torch_ranks import ROOT
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro_torch.checkpoint.checkpoint import _flatten, _leaf_name
from repro_torch.config import SHAPES, shape_applicable
from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.core.roofline import COLL_KINDS, wire_bytes
from repro_torch.launch import specs as sp
from repro_torch.models import encdec, lm, model_for

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GROUPS = (2, 4, 16)
TIMEOUT = 300

_REFERENCE = """
import json, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.checkpoint.checkpoint import _leaf_name
from repro.config import SHAPES, shape_applicable
from repro.configs import get_config
from repro.core.roofline import _line_wire_bytes
from repro.launch import specs as sp
from repro.parallel import sharding as sh

OUT = sys.argv[1]
ARCHS, GROUPS = json.loads(sys.argv[2]), json.loads(sys.argv[3])
devs = np.array(jax.devices())
meshes = {"16x16": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          "2x16x16": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}

def leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_name(p): [list(x.shape), str(x.dtype)] for p, x in flat}

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {_leaf_name(p): [list(e) if isinstance(e, tuple) else e
                            for e in s.spec] for p, s in flat}

out = {"archs": {}}
for arch in ARCHS:
    cfg = get_config(arch)
    st = sp.state_specs(cfg)
    shapes = [n for n, s in SHAPES.items() if shape_applicable(cfg, s)[0]]
    r = {"state": leaves(st),
         "serve": {d: leaves(sp.serve_param_specs(cfg, d))
                   for d in ("f32", "bf16", "bfp8")},
         "batch": {n: leaves(sp.batch_specs(cfg, SHAPES[n])) for n in shapes},
         "cache": {n: leaves(sp.cache_specs(cfg, SHAPES[n])) for n in shapes},
         "shard": {}}
    for mn, mesh in meshes.items():
        with sh.use_mesh_rules(mesh, None):
            d = {f"state_{k}": specs(sp.state_shardings(cfg, st, mesh, **kw))
                 for k, kw in (("zero1", {}), ("plain", {"zero1": False}),
                               ("fsdp", {"fsdp": True}))}
            for n in shapes:
                shape = SHAPES[n]
                d["batch_" + n] = specs(sp.batch_shardings(
                    cfg, shape, mesh, sp.batch_specs(cfg, shape)))
                d["cache_" + n] = specs(sp.cache_shardings(
                    cfg, sp.cache_specs(cfg, shape), mesh))
        r["shard"][mn] = d
    out["archs"][arch] = r
out["wire"] = {}
for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"):
    for g in GROUPS:
        line = (f"  %c.1 = bf16[{4 * g},96]{{1,0}} {kind}(bf16[8,96]{{1,0}} "
                f"%p.0), channel_id=1, replica_groups=[{32 // g},{g}]"
                f"<=[32], use_global_device_ids=true")
        out["wire"][f"{kind}/{g}"] = list(_line_wire_bytes(line)) + [
            4 * g * 96 * 2]
with open(OUT + "/specs.json", "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
         json.dumps(LM_ARCHS), json.dumps(GROUPS)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0 and "OK" in p.stdout, \
        (p.stdout + p.stderr)[-4000:]
    with open(out / "specs.json") as f:
        return json.load(f)


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _leaves(tree) -> dict:
    return {_leaf_name(p): [list(t.shape), _dtype(t)]
            for p, t in _flatten(tree)}


def _json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _specs(tree) -> dict:
    return {_leaf_name(p): _json(s.spec) for p, s in _flatten(tree)}


def _ref_layout(cfg, tree):
    """A params-shaped tree in the reference's layout."""
    return model_for(cfg).to_reference_layout(tree, cfg)


def _ref_caches(cfg, caches):
    """The port's per-layer caches stacked as the reference's."""
    return lm.to_reference_layout({"stack": caches}, cfg)["stack"]


def _state_ref_layout(cfg, state):
    return {"step": state["step"],
            **{k: _ref_layout(cfg, state[k]) for k in ("params", "m", "v")}}


def _without_port_leaves(d: dict) -> dict:
    """The port's cross caches carry one more leaf, ``clen`` (the
    encoder rows a slot's prefill wrote), which the reference has not."""
    return {k: v for k, v in d.items() if not k.endswith("__clen")}


def _shapes(cfg):
    return [n for n, s in SHAPES.items() if shape_applicable(cfg, s)[0]]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_stand_ins_equal_the_reference_at_full_width(ref, arch):
    """(a) Every leaf's shape and dtype: the train state (f32 moments,
    the int32 step), the serving weights in f32, bf16 and bfp8 (the
    compressed linears' ``w_q`` / ``w_e``), and for every applicable
    shape the batch and the caches, at the published widths."""
    want = ref["archs"][arch]
    cfg = get_config(arch)
    state = sp.state_specs(cfg)
    assert all(t.device.type == "meta" for _, t in _flatten(
        {k: state[k] for k in ("params", "m", "v")}))
    assert _leaves(_state_ref_layout(cfg, state)) == want["state"]
    for dtype in ("f32", "bf16", "bfp8"):
        got = _leaves(_ref_layout(cfg, sp.serve_param_specs(cfg, dtype)))
        assert got == want["serve"][dtype], dtype
    assert any(k.endswith("w_q") for k in want["serve"]["bfp8"])
    assert sorted(want["batch"]) == sorted(_shapes(cfg))
    for n in _shapes(cfg):
        shape = SHAPES[n]
        assert _leaves(sp.batch_specs(cfg, shape)) == want["batch"][n], n
        got = _leaves(_ref_caches(cfg, sp.cache_specs(cfg, shape)))
        assert _without_port_leaves(got) == want["cache"][n], n
        extra = set(got) - set(want["cache"][n])
        assert all(k.endswith("__clen") for k in extra), extra
        assert (model_for(cfg) is encdec) == bool(extra)


def _stack_cfgs(cfg) -> dict:
    """Each layer list of the family and its stack's config."""
    if model_for(cfg) is encdec:
        return {"enc_stack": encdec.enc_cfg(cfg), "dec_stack": cfg}
    return {"stack": cfg}


def _per_layer_agrees(port_specs, ref_specs, cfg) -> int:
    """Each leaf of the port's state (its layer lists) has the spec of its
    leaf in the reference's layout; a per-layer leaf its stacked leaf's
    without the layers entry, where the reference leaves that entry
    whole.  Returns the leaves checked."""
    stacks = _stack_cfgs(cfg)
    checked = 0
    for path, s in _flatten(port_specs):
        c = stacks.get(path[1]) if len(path) > 2 else None
        layered = False
        ref_path = path
        if c is not None:
            i, n_prefix = path[2], lm._n_prefix(c)
            if i < n_prefix:
                ref_path = path[:2] + ("prefix", i) + path[3:]
            else:
                j = (i - n_prefix) % c.pattern_period()
                ref_path = path[:2] + ("scan", f"b{j}") + path[3:]
                layered = True
        want = ref_specs[_leaf_name(ref_path)]
        if layered:
            if want[0] is not None:
                continue
            want = want[1:]
        assert _json(s.spec) == want, path
        checked += 1
    return checked


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shardings_equal_the_reference(ref, arch, mesh):
    """(b) ``state_shardings`` (ZeRO-1 on and off, FSDP),
    ``batch_shardings`` and ``cache_shardings``: every leaf's spec the
    reference's on its 16x16 and 2x16x16 meshes, taken on the reference's
    layout; on the port's layer list each leaf's spec is its stacked
    leaf's without the layers entry."""
    want = ref["archs"][arch]["shard"][mesh]
    m = MESHES[mesh]
    cfg = get_config(arch)
    state = sp.state_specs(cfg)
    state_ref = _state_ref_layout(cfg, state)
    for key, kw in (("zero1", {}), ("plain", {"zero1": False}),
                    ("fsdp", {"fsdp": True})):
        got = sp.state_shardings(cfg, state_ref, m, **kw)
        assert _specs(got) == want["state_" + key], key
    for key, kw in (("plain", {"zero1": False}), ("zero1", {})):
        per_layer = sp.state_shardings(cfg, state, m, **kw)
        assert _per_layer_agrees(per_layer, want["state_" + key], cfg) > 0
    for n in _shapes(cfg):
        shape = SHAPES[n]
        got = sp.batch_shardings(cfg, shape, m, sp.batch_specs(cfg, shape))
        assert _specs(got) == want["batch_" + n], n
        caches = sp.cache_specs(cfg, shape)
        got = _specs(sp.cache_shardings(cfg, _ref_caches(cfg, caches), m))
        assert _without_port_leaves(got) == want["cache_" + n], n
        assert any(s != [None] * len(s) for s in got.values())


@pytest.mark.parametrize("kind", COLL_KINDS)
def test_wire_bytes_equal_the_reference_parser(ref, kind):
    """(c) ``roofline.wire_bytes`` against the reference's
    ``_line_wire_bytes`` on a synthesized HLO collective line of a bf16
    result, at group sizes 2, 4 and 16."""
    for g in GROUPS:
        ref_kind, ref_wire, result = ref["wire"][f"{kind}/{g}"]
        assert ref_kind == kind
        assert wire_bytes(kind, result, g) == ref_wire, g
