"""The port's dry run on the CPU: the counter (``core/opcount.py``) on
hand-checked programs, the kernels' meta branches, the meshless reduced
train step's FLOPs against the reference's ``analyze_hlo``, whole cells
(``launch/dryrun.py::run_cell``) on a fake (2, 4) world, AdamW with
ZeRO-1 moments on 8 gloo ranks, and the CLI with both scripts.

Everything that starts a process group runs in a subprocess: the fake
world's cells in one, the gloo ranks through ``tests/_torch_ranks.py``,
the reference (which compiles its meshless steps at 8 x 64, as the
reference's dry run does, and counts them with ``analyze_hlo``) in a
third, all started at once.  Counts are exact unless a test says
otherwise.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _torch_ranks import ROOT, run_ranks
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro_torch.config import ShapeCfg
from repro_torch.configs import get_config
from repro_torch.core import opcount
from repro_torch.core.opcount import OpCounter
from repro_torch.kernels.bfp_matmul import bfp_matmul
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv import winograd
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.decode_attn import ops as dec_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd
from repro_torch.launch import dryrun
from repro_torch.launch import specs as sp
from repro_torch.nn import flash
from repro_torch.nn.blocks import stack_kinds
from repro_torch.nn.module import count_params, tree_leaves
from repro_torch.parallel import sharding as sh

ARCHS = ["smollm-360m", "granite-moe-1b-a400m", "mamba2-2.7b"]
SMALL = ShapeCfg("t", 64, 8, "train")
TIMEOUT = 240

_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp
from repro.config import ShapeCfg
from repro.configs import get_config
from repro.core import roofline as rl
from repro.core.winograd import conv1d_depthwise_causal
from repro.launch import specs as sp
from repro.launch.dryrun import _layer_trips

OUT, ARCHS = sys.argv[1], json.loads(sys.argv[2])
shape = ShapeCfg("t", 64, 8, "train")
out = {}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    c = jax.jit(sp.make_train_step(cfg)).lower(
        sp.state_specs(cfg), sp.batch_specs(cfg, shape)).compile()
    out[arch] = rl.analyze_hlo(c.as_text(),
                               default_trip=_layer_trips(cfg))["flops"]
    if cfg.ssm is not None:
        # the Winograd conv of the x channels, forward and VJP, one layer
        C, k = cfg.d_inner, cfg.ssm.conv_kernel
        f = lambda x, w, b: jnp.sum(conv1d_depthwise_causal(x, w, b) * 1.5)
        s = lambda *d: jax.ShapeDtypeStruct(d, jnp.float32)
        g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2))).lower(
            s(8, 64, C), s(k, C), s(C)).compile()
        out[arch + "/winograd_conv"] = rl.analyze_hlo(g.as_text())["flops"]
with open(OUT + "/flops.json", "w") as f:
    json.dump(out, f)
print("OK")
"""

_CELLS = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.config import ShapeCfg
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

OUT, ARCHS = sys.argv[1], json.loads(sys.argv[2])
recs = []
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    for kind in ("train", "decode"):
        recs.append(dryrun.run_cell(arch, "t", cfg=cfg,
                                    shape=ShapeCfg("t", 64, 8, kind),
                                    mesh_shape=(2, 4)))
    # the same train step with the params split over "data" too
    recs.append(dryrun.run_cell(arch, "t_fsdp", cfg=cfg,
                                shape=ShapeCfg("t_fsdp", 64, 8, "train"),
                                mesh_shape=(2, 4), fsdp=True))
# the reference's reason for an inapplicable cell
recs.append(dryrun.run_cell("smollm-360m", "long_500k"))
# a step that cannot run: an error record with its traceback, and the
# fake world ended (the next cell starts its own)
recs.append(dryrun.run_cell("smollm-360m", "t", cfg=get_config(
    "smollm-360m").reduced(), shape=ShapeCfg("t", 64, 6, "train"),
    mesh_shape=(4, 2)))
recs.append(dryrun.run_cell("mamba2-2.7b", "t", cfg=get_config(
    "mamba2-2.7b").reduced(), shape=ShapeCfg("t", 64, 8, "prefill"),
    mesh_shape=(2, 2, 2)))
with open(OUT + "/cells.json", "w") as f:
    json.dump(recs, f)
print("OK")
"""

_ZERO1 = """
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.optim import adamw_step
from repro_torch.parallel import sharding as sh

cfg = get_config("smollm-360m").reduced()
mesh = make_mesh((4, 2), ("data", "model"))
params = lm.init(0, cfg, device="cpu")
zeros = tree_map(lambda p: torch.zeros_like(p), params)

def state(moment_sh):
    return {"step": torch.zeros((), dtype=torch.int32),
            "params": sh.place_tree(params, sh.param_shardings(params, mesh)),
            "m": sh.place_tree(zeros, moment_sh),
            "v": sh.place_tree(zeros, moment_sh)}

like = state(sh.param_shardings(params, mesh))
zero1 = state(sh.zero1_shardings(params, mesh))
finer = sum(sh.local(m).numel() < sh.local(p).numel() for m, p in zip(
    tree_leaves(zero1["m"]), tree_leaves(zero1["params"])))
for step in range(3):
    rng = np.random.default_rng(step)
    grads = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                              .astype(np.float32))
             for p in tree_leaves(params)]
    for st in (like, zero1):
        adamw_step(st, grads, lr=torch.tensor(3e-3), weight_decay=0.1)
same = all(torch.equal(sh.full(a), sh.full(b))
           for k in ("params", "m", "v")
           for a, b in zip(tree_leaves(like[k]), tree_leaves(zero1[k])))
moved = not torch.equal(sh.full(tree_leaves(like["params"])[0]),
                        tree_leaves(params)[0])
print(f"RESULT {int(same)} {finer} {int(moved)}")
"""

_CLI = """
set -e
export PYTHONPATH={src}
cd {out}
python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k \\
    --mesh single --reduced --keep-ops --out {out}/dryrun.jsonl
python {root}/scripts/hillclimb_torch.py --arch smollm-360m \\
    --shape decode_32k --reduced --name f32_weights --serve-dtype f32 \\
    --baseline {out}/dryrun.jsonl --out {out}/hillclimb.jsonl
python {root}/scripts/make_experiments_torch.py {out}/dryrun.jsonl
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference's counts, the fake world's cells, the CLI run and the
    8 gloo ranks' ZeRO-1 check, all started at once."""
    out = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
             json.dumps(ARCHS)], env=dict(env, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "cells": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_CELLS), str(out),
             json.dumps(ARCHS)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "cli": subprocess.Popen(
            ["bash", "-c", _CLI.format(src=src, out=out, root=ROOT)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    logs = {}
    try:
        ranks = run_ranks(_ZERO1, 8, out / "ranks", timeout=TIMEOUT)
        for name, p in procs.items():
            logs[name], _ = p.communicate(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name in ("ref", "cells"):
        assert procs[name].returncode == 0 and "OK" in logs[name], \
            logs[name][-4000:]
    with open(out / "flops.json") as f:
        flops = json.load(f)
    with open(out / "cells.json") as f:
        cells = json.load(f)
    return {"flops": flops, "cells": cells, "ranks": ranks, "out": out,
            "cli": (procs["cli"].returncode, logs["cli"])}


# --- (d) the counter on hand-checked programs --------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counter_counts_a_matmul_its_bytes_and_nothing_for_views():
    """An (M, K) @ (K, N) counts 2 M N K FLOPs and its operands' and
    result's bytes; views and an allocation count nothing; a copy reads
    its source and writes its destination; a fill writes its result."""
    M, K, N = 24, 40, 56
    a, b = _meta(M, K), _meta(K, N)
    with OpCounter(keep_ops=True) as c:
        y = a @ b
    assert c.flops == 2 * M * N * K
    assert c.hbm_bytes == 4 * (M * K + K * N + M * N)
    assert c.ops == 1
    with OpCounter() as c:
        a.view(K, M).t()[3:17].unsqueeze(0).squeeze(0)
        a.transpose(0, 1).expand(2, K, M)
        torch.empty((1000,), device="meta")
    assert (c.flops, c.hbm_bytes, c.ops) == (0, 0, 0)
    with OpCounter() as c:
        y.copy_(_meta(M, 1).expand(M, N))
    assert c.hbm_bytes == 4 * (M * N + M)
    with OpCounter() as c:
        torch.zeros((M, N), device="meta")
    assert c.hbm_bytes == 4 * M * N
    # batched, with a bias, and an einsum: 2 x result x contracted
    with OpCounter() as c:
        torch.baddbmm(_meta(3, M, N), _meta(3, M, K), _meta(3, K, N))
        torch.einsum("bik,bkj->bij", _meta(3, M, K), _meta(3, K, N))
    assert c.flops == 2 * (2 * 3 * M * N * K)


def test_counter_tracks_live_bytes_and_in_place_cache_writes():
    """Peak live bytes count each storage from the op that makes it until
    it dies; an indexed write in place counts its values twice and its
    indices once, not the whole buffer."""
    buf = _meta(4, 1024, 8)
    with OpCounter() as c:
        c.arguments(buf)
        t = torch.ones((1 << 20,), device="meta")
        del t
        u = torch.ones((1 << 18,), device="meta")
        rows = torch.arange(4, device="meta")[:, None]
        idx = torch.full((4, 1), 5, dtype=torch.long, device="meta")
        buf[rows, idx] = _meta(4, 1, 8)
    mem = c.memory(buf, u)
    assert mem["argument_size"] == 4 * 4 * 1024 * 8
    assert mem["temp_size"] >= 4 << 20
    assert mem["alias_size"] == mem["argument_size"]
    assert mem["output_size"] == mem["argument_size"] + 4 * (1 << 18)
    assert mem["generated_code_size"] == 0
    # the last op: 2 x the 4 x 8 written values + the broadcast indices
    with OpCounter(keep_ops=True) as c:
        buf[rows, idx] = _meta(4, 1, 8)
    assert c.by_op["aten.index_put_.default"][2] == \
        2 * 4 * 32 + 8 * 4 + 8 * 4


def test_flash_attention_on_meta_counts_its_blocks():
    """The flash op gives ``_fwd``'s shapes on meta; under the counter its
    body's ops are counted: q.k and p.v, 4 B H qc kc D a block, over the
    blocks it computes (the banded schedule skips the upper triangle)."""
    B, S, H, KV, D = 2, 96, 4, 2, 16
    q, k = _meta(B, S, H, D), _meta(B, S, KV, D)
    o = flash.flash_attention(q, k, k, causal=True, q_chunk=32, k_chunk=32)
    assert o.shape == q.shape and o.dtype == q.dtype
    for banded, blocks in ((False, 9), (True, 6)):
        with OpCounter() as c:
            flash.flash_attention(q, k, k, causal=True, q_chunk=32,
                                  k_chunk=32, banded=banded)
        assert c.flops == blocks * 4 * B * H * 32 * 32 * D


# --- (h) the kernels' meta branches ------------------------------------------
def _cpu(t, rng):
    return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)).to(t.dtype)


def _launches():
    return {**dec_ops.launch_counts(), **ssd_ops.launch_counts(),
            **conv_ops.launch_counts()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_meta_branches_give_the_plain_shapes_and_their_work(dtype):
    """Kernels 5, 6 and 7 (forward, dx, wgrad) on meta tensors: outputs
    of the plain versions' shapes and dtypes, one launch recorded each
    (``launch_counts`` untouched: nothing launched), the work of each
    kernel's own work function, and the CUDA path's scratch live."""
    rng = np.random.default_rng(0)
    before = _launches()
    B, S, H, KV, D = 3, 40, 8, 2, 16
    q, kc = _meta(B, 1, H, D, dtype=dtype), _meta(B, S, KV, D, dtype=dtype)
    lengths = torch.full((B,), S - 1, dtype=torch.int32, device="meta")
    Bs, L, Hs, P, G, N, Q = 2, 40, 4, 8, 1, 16, 16
    x = _meta(Bs, L, Hs, P, dtype=dtype)
    dt, A = _meta(Bs, L, Hs), _meta(Hs)
    bm = _meta(Bs, L, G, N, dtype=dtype)
    Bc, Lc, C, r = 2, 50, 24, 4
    xc, w, b = _meta(Bc, Lc, C, dtype=dtype), _meta(r, C), _meta(C)
    calls = {
        "decode_attn": (lambda: decode_attn.decode_attention(
            q, kc, kc, lengths), lambda: decode_attn.decode_attention_ref(
            _cpu(q, rng), _cpu(kc, rng), _cpu(kc, rng),
            torch.full((B,), S - 1)), decode_attn.decode_work(
            B, H, KV, D, B * S, q.element_size()),
            4 * math.prod(decode_attn.scratch_shape(B, S, KV, H // KV, D))),
        "ssd": (lambda: ssd.ssd_chunked_pallas(x, dt, A, bm, bm, chunk=Q),
                lambda: ssd.ssd_chunked_plain(
                    _cpu(x, rng), _cpu(dt, rng).abs(), -_cpu(A, rng).abs(),
                    _cpu(bm, rng), _cpu(bm, rng), chunk=Q),
                ssd.ssd_work(Bs, L, Hs, P, G, N, Q, x.element_size()),
                4 * ssd.scratch_numel(Bs, L, Hs, P, G, N, Q)),
        "dw1d": (lambda: winograd.conv1d_depthwise_causal(xc, w, b),
                 lambda: winograd.conv1d_depthwise_causal(
                     _cpu(xc, rng), _cpu(w, rng), _cpu(b, rng)),
                 winograd.dw1d_work(Bc, Lc, C, xc.element_size(), r), 0),
        "dw1d_bwd": (lambda: winograd.conv1d_depthwise_causal_dx(xc, w),
                     lambda: winograd.conv1d_depthwise_causal_dx(
                         _cpu(xc, rng), _cpu(w, rng)),
                     winograd.dw1d_bwd_work(Bc, Lc, C, xc.element_size(),
                                            "dx", r), 0),
        "dw1d_wgrad": (lambda: winograd.conv1d_depthwise_causal_wgrad(
            xc, xc, r), lambda: winograd.conv1d_depthwise_causal_wgrad(
            _cpu(xc, rng), _cpu(xc, rng), r), winograd.dw1d_bwd_work(
            Bc, Lc, C, xc.element_size(), "wgrad", r),
            4 * math.prod(winograd.dw1d_wgrad_scratch_shape(Bc, Lc, C, r)))}
    for name, (meta_call, plain_call, (flops, nbytes), scratch) in \
            calls.items():
        with OpCounter() as c:
            got = meta_call()
        want = plain_call()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want], name
        assert dict(c.launches) == {name: 1}, name
        assert (c.kernel_flops[name], c.kernel_bytes[name]) == \
            (flops, nbytes), name
        assert c.peak >= scratch + sum(t.untyped_storage().nbytes()
                                       for t in got), name
        assert flops > 0 and nbytes > 0
    assert _launches() == before


def test_cnn_kernels_and_unknown_devices_still_raise_on_meta():
    """Kernels 1-4 are on no dry-run path (the reference's dry run
    excludes the CNNs): they refuse meta tensors, as any wrapper refuses
    a device it does not know."""
    wq, we = bfp_matmul.quantize_weights(torch.zeros((64, 32)))
    with pytest.raises(ValueError, match="unsupported device meta"):
        bfp_matmul.bfp_matmul(_meta(8, 64), wq.to("meta"), we.to("meta"))
    x, w = _meta(1, 8, 8, 3), _meta(3, 3, 3, 4)
    with pytest.raises(ValueError, match="unsupported device meta"):
        conv_ops.conv2d_direct(x, w, stride=1)
    with pytest.raises(ValueError, match="unsupported device meta"):
        conv_ops.conv2d(x, w)


# --- (e) the meshless reduced train step against the reference --------------
def _meshless_count(arch):
    cfg = get_config(arch).reduced()
    counter, _, _ = dryrun.count_step(
        sp.make_train_step(cfg), sp.state_specs(cfg),
        sp.batch_specs(cfg, SMALL))
    return cfg, counter


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_meshless_train_step_flops_equal_analyze_hlo(spawned, arch):
    """(e) The reduced train step at 8 x 64, counted on meta: FLOPs equal
    to the reference's ``analyze_hlo`` of its compiled step, the flash
    attention forward included."""
    _, c = _meshless_count(arch)
    assert c.flops == spawned["flops"][arch]


def test_mamba_train_step_flops_differ_by_the_named_terms(spawned):
    """(e) mamba2-2.7b's count differs from ``analyze_hlo``'s by two named
    terms, and by nothing else: (1) kernel 7 (forward, dx, wgrad) counts
    its function's work (``winograd.dw1d_work``, 2 r + 1 operations an
    output) where the reference's pure-jnp Winograd conv shows XLA the
    transforms' dots; (2) the reference's three-operand SSD einsum
    ``bcqgn,bcghnp,bcqgh->bcqghp`` has XLA multiply C by the decay as a
    dot with no contracted dim (2 B nc Q G H N a layer), which torch
    multiplies elementwise.  The totals are within 2.5%."""
    cfg, c = _meshless_count("mamba2-2.7b")
    ref = spawned["flops"]
    layers = cfg.num_layers
    k7 = sum(c.kernel_flops[k] for k in ("dw1d", "dw1d_bwd", "dw1d_wgrad"))
    assert dict(c.launches) == {"dw1d": layers, "dw1d_bwd": layers,
                                "dw1d_wgrad": layers}
    s = cfg.ssm
    nc = -(-SMALL.seq_len // s.chunk)
    outer = layers * 2 * SMALL.global_batch * nc * s.chunk * s.ngroups \
        * cfg.ssm_heads * s.d_state
    winograd_dots = layers * ref["mamba2-2.7b/winograd_conv"]
    assert c.flops - k7 == ref["mamba2-2.7b"] - winograd_dots - outer
    assert abs(c.flops / ref["mamba2-2.7b"] - 1) < 0.025


# --- (f) cells on a fake (2, 4) world ----------------------------------------
def _tp_wire_bytes(cfg, B=8, S=64, data=2, m=4, fsdp=False):
    """(reduce-scatter, all-gather, all-reduce) wire bytes of the (2, 4)
    tensor-parallel train step of a reduced config (f32, its heads, MLP
    columns, experts and SSM heads split 4 ways), from the specs.  Each
    sublayer's normed input is gathered along the sequence and its
    partial sum reduce-scattered (ring factors: all-gather R (m-1)/m,
    reduce-scatter R (m-1)), the backward mirroring both, and the stack's
    exit gathers the residual; where the KV heads do not split but their
    columns do, K and V are gathered by columns.  The ZeRO-1 update is
    gathered over "data" (g = 2).  All-reduced: over "data" each rank's
    f32 gradient blocks, the step's three-float sums and per MoE layer the
    router loss's two means and the backward of one; over "model" the
    replicated leaves' gradients, the norm's block sum of squares and per
    SSM layer the gated RMSNorm's sums of squares, forward and backward.
    ``fsdp``: the params placed like the ZeRO-1 moments, so no update is
    gathered; each leaf split over "data" is gathered at each use (the
    tied embedding twice: lookup and readout; no remat at the reduced
    config) and its gradient reduce-scattered (g = 2), and neither it nor
    its block of the norm's sum of squares is all-reduced over "data":
    the norm's sums are all-reduced once for each set of mesh dims that
    split their leaves' gradients (of "data" and "model")."""
    mesh = {"data": data, "model": m}
    f = 4
    Bl, d = B // data, cfg.d_model
    kinds = stack_kinds(cfg)
    subs = sum(1 + (ffn != "none") for _, ffn in kinds)
    n_attn = sum(mx == "attn" for mx, _ in kinds)
    n_ssm = sum(mx == "ssm" for mx, _ in kinds)
    whole = Bl * S * d * f
    rs = (2 * subs + 1) * whole / m * (m - 1)
    ag = (2 * subs + 1) * whole * (m - 1) / m
    kvw = cfg.num_kv_heads * cfg.d_head
    if n_attn and cfg.num_heads % m == 0 and cfg.num_kv_heads % m \
            and kvw % m == 0:
        col = Bl * S * kvw * f
        rs += 2 * n_attn * col / m * (m - 1)
        ag += 2 * n_attn * col * (m - 1) / m
    st = sp.state_specs(cfg)
    with sh.use_mesh_rules(mesh):
        ps = sh.param_shardings(st["params"], mesh)
        z1 = sh.zero1_shardings(st["params"], mesh)
    local = rep = finer = 0
    norm_sets = set()
    names = _leaf_names(st["params"])
    for name, p, s_, z in zip(names, tree_leaves(st["params"]),
                              tree_leaves(ps), tree_leaves(z1)):
        n = p.numel() // (m if "model" in s_.spec else 1)
        if fsdp and "data" in z.spec:
            uses = 2 if name.startswith("embed/") and \
                cfg.tie_embeddings else 1
            ag += uses * n * f / 2
            rs += uses * n * f / 2
            rep += 0 if "model" in s_.spec else n / 2
            norm_sets.add(("data", "model") if "model" in s_.spec
                          else ("data",))
            continue
        local += n
        rep += 0 if "model" in s_.spec else n
        finer += n if "data" in z.spec else 0
        if "model" in s_.spec:
            norm_sets.add(("model",))
    if not fsdp:
        ag += finer * f / 2
    experts = cfg.moe.num_experts if cfg.moe else 0
    n_moe = sum(ffn == "moe" for _, ffn in kinds)
    norm = sum(f * (("data" in axes) + 2 * (m - 1) / m * ("model" in axes))
               for axes in norm_sets)
    ar = (f * local + 12 + n_moe * 3 * 4 * experts + norm
          + 2 * (m - 1) / m * (f * rep + n_ssm * 2 * Bl * S * f))
    return rs, ag, ar


def _leaf_names(tree, path=""):
    """Each leaf's path, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}" if path else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}/{i}")]
    return [path]


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_on_a_fake_world(spawned, arch):
    """(f) ``run_cell`` on a fake (2, 4) world for the reduced config at
    8 x 64, the tensor-parallel step: ``ok``, FLOPs a rank under half the
    meshless step's (4 of 8 rows, each layer split 4 ways), the
    reduce-scatter, all-gather and all-reduce wire bytes equal to the
    sums derived from the specs, collectives inside the layers, the
    kernels' launches; the decode cell too."""
    recs = {r["kind"]: r for r in spawned["cells"]
            if r["arch"] == arch and r["mesh"] == "2x4" and r["shape"] == "t"}
    cfg = get_config(arch).reduced()
    train = recs["train"]
    assert train["status"] == "ok", train.get("traceback")
    t = train["roofline"]
    assert t["chips"] == 8 and t["flops_per_device"] > 0
    cb = t["coll_breakdown"]
    rs, ag, ar = _tp_wire_bytes(cfg)
    assert cb["reduce-scatter"] == rs and cb["all-gather"] == ag
    assert cb["all-reduce"] == pytest.approx(ar, rel=1e-12)
    _, meshless = _meshless_count(arch)
    assert meshless.flops / 8 < t["flops_per_device"] < meshless.flops / 2
    assert set(train["memory"]) == {"argument_size", "output_size",
                                    "temp_size", "alias_size",
                                    "generated_code_size"}
    assert train["memory"]["alias_size"] > 0
    assert train["t_count_s"] >= 0 and train["ops"] > 0
    if cfg.ssm is not None:
        assert train["launches"] == {"dw1d": 2, "dw1d_bwd": 2,
                                     "dw1d_wgrad": 2}
    assert cb["in_loop_count"] > 0
    decode = recs["decode"]
    assert decode["status"] == "ok", decode.get("traceback")
    want = {} if cfg.ssm is not None else {
        "decode_attn": sum(m == "attn" for m, _ in stack_kinds(cfg))}
    assert decode["launches"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_cells_on_a_fake_world(spawned, arch):
    """(f) The same train cell under ``--fsdp`` (the params split over
    "data" as well, each layer gathering its leaves at its use): ``ok``,
    the all-gather, reduce-scatter and all-reduce wire bytes equal to the
    sums derived from the specs, more collectives inside the layers (the
    gathers and their reduce-scatters) and fewer argument bytes a rank
    than the non-FSDP cell's."""
    recs = {r["shape"]: r for r in spawned["cells"]
            if r["arch"] == arch and r["mesh"] == "2x4"
            and r["kind"] == "train"}
    cfg = get_config(arch).reduced()
    cell, base = recs["t_fsdp"], recs["t"]
    assert cell["status"] == "ok", cell.get("traceback")
    cb, cb0 = (r["roofline"]["coll_breakdown"] for r in (cell, base))
    rs, ag, ar = _tp_wire_bytes(cfg, fsdp=True)
    assert cb["reduce-scatter"] == pytest.approx(rs, rel=1e-12)
    assert cb["all-gather"] == pytest.approx(ag, rel=1e-12)
    assert cb["all-reduce"] == pytest.approx(ar, rel=1e-12)
    assert cb["in_loop_count"] > cb0["in_loop_count"]
    assert cell["memory"]["argument_size"] < base["memory"]["argument_size"]
    if cfg.ssm is not None:
        assert cell["launches"] == base["launches"]


def test_skipped_and_error_records(spawned):
    """An inapplicable cell is skipped with the reference's reason; a
    step that cannot run is an error record with its traceback (6 rows
    do not split over 4 data ranks), and the next cell runs in a fresh
    fake world: a reduced mamba prefill on 2x2x2, kernels 6 and 7."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in spawned["cells"]}
    skip = by[("smollm-360m", "long_500k", "16x16")]
    assert skip["status"] == "skipped"
    assert skip["reason"] == ("full-attention arch: 500k decode needs a "
                              "sub-quadratic mixer")
    err = by[("smollm-360m", "t", "4x2")]
    assert err["status"] == "error"
    assert "does not split" in err["error"] and "Traceback" in \
        err["traceback"]
    pre = by[("mamba2-2.7b", "t", "2x2x2")]
    assert pre["status"] == "ok", pre.get("traceback")
    assert pre["launches"] == {"ssd": 2, "dw1d": 2}


# --- (g) ZeRO-1 moments ------------------------------------------------------
def test_adamw_with_zero1_moments_is_bit_equal(spawned):
    """(g) On 8 gloo ranks, a (4, 2) mesh: AdamW with its moments placed
    by ``zero1_shardings`` (finer than the params) gives, over 3 steps,
    the params and moments of moments placed like the params, bit for
    bit, on every rank."""
    for log in spawned["ranks"]:
        line = next(l for l in log.splitlines() if l.startswith("RESULT"))
        same, finer, moved = map(int, line.split()[1:])
        assert same == 1 and moved == 1
        assert finer > 0


# --- (i) the CLI and the two scripts -----------------------------------------
def test_cli_and_scripts_on_a_reduced_cell(spawned):
    """(i) ``python -m repro_torch.launch.dryrun --reduced --keep-ops``
    writes an ``ok`` record and its op table; ``hillclimb_torch.py``
    counts a variant beside it; ``make_experiments_torch.py`` prints both
    tables with the H100's data-sheet line."""
    rc, log = spawned["cli"]
    assert rc == 0, log[-4000:]
    out = spawned["out"]
    with open(out / "dryrun.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["launches"] == {"decode_attn": 2}
    assert os.path.getsize(out / rec["ops_path"]) > 0
    with open(out / "hillclimb.jsonl") as f:
        var = json.loads(f.readline())
    assert var["variant"] == "f32_weights" and var["status"] == "ok"
    assert "step-time speedup vs baseline" in log
    assert "| smollm-360m | decode_32k | 16x16 | ok |" in log
    assert "H100 SXM data sheet at 700 W" in log
    assert "**" in log.split("## Roofline")[1]


def test_meta_init_draws_nothing():
    """Params on meta are shapes only: the host generator is not
    advanced, and jamba-v0.1-52b's full-width state builds at once."""
    gen = torch.Generator().manual_seed(7)
    before = gen.get_state()
    from repro_torch.models import lm
    p = lm.init(gen, get_config("smollm-360m"), device="meta")
    assert torch.equal(gen.get_state(), before)
    assert p["embed"]["embedding"].device.type == "meta"
    state = sp.state_specs(get_config("jamba-v0.1-52b"))
    assert count_params(state["params"]) > 51e9
    assert opcount.counting() is False
