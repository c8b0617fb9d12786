"""The port's mesh trainer on gloo ranks on the CPU: the reference's
elastic scenario, the sharded checkpoint and the ``--mesh`` launcher.

Reduced smollm-360m, ``TrainerConfig(steps=6, batch=4, seq_len=32,
base_lr=1e-3)``: 6 steps on a (4, 2) ("data", "model") mesh of 8 ranks,
``reshard_state`` onto (2, 2) (ranks 4-7 leave), on to step 10; held to
an uninterrupted (4, 2) run, to the port's one-process run and to the
reference's 10-step (4, 2) run from the same params (the reference in a
subprocess with 8 forced host devices and an Auto-axis mesh, ROADMAP
Queue 3), all within the reference test's bound, rtol 2e-3 / atol 2e-4.
Reduced granite-moe-1b-a400m (its router loss) and mamba2-2.7b take 3
steps on the (2, 2) mesh against the one-process run.  One spawn of 8
ranks carries every check; the reference and the one-process runs go on
beside it.
"""
import json
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
from _torch_ranks import ROOT, run_ranks
from _torch_threads import torch_one_thread  # noqa: F401  (fixture)

from repro.configs import get_config as j_get_config
from repro.models import lm as j_lm
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.nn.module import tree_leaves, tree_map_with_path
from repro_torch.runtime import Trainer, TrainerConfig

RTOL, ATOL = 2e-3, 2e-4          # the reference test's bound
TC = dict(steps=6, batch=4, seq_len=32, base_lr=1e-3, log_every=1)
SMALL_ARCHS = ("granite-moe-1b-a400m", "mamba2-2.7b")
SMALL_STEPS = 3
TIMEOUT = 120

_REFERENCE = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.runtime import Trainer, TrainerConfig
out, tc = sys.argv[1], eval(sys.argv[2])
with open(out + "/init.pkl", "rb") as f:
    params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
tr = Trainer(get_config("smollm-360m").reduced(),
             TrainerConfig(**dict(tc, steps=10)), mesh=mesh, params=params)
tr.run()
with open(out + "/reference.pkl", "wb") as f:
    pickle.dump({"params": jax.tree_util.tree_map(np.asarray,
                                                  tr.state["params"]),
                 "losses": [h["loss"] for h in tr.history]}, f)
print("OK")
"""

_RANKS = """
import json, pickle
import numpy as np
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.parallel import sharding as sh
from repro_torch.runtime import Trainer, TrainerConfig, reshard_state

TC, SMALL_ARCHS, SMALL_STEPS = {tc}, {small}, {steps}
cfg = get_config("smollm-360m").reduced()
with open(OUT + "/init.pkl", "rb") as f:
    init = pickle.load(f)

def params0():
    return lm.params_from_reference(init, cfg, device="cpu")

def whole(tree):
    return [sh.full(t).detach().numpy() for t in tree_leaves(tree)]

def dump(name, *arrays):
    np.savez(f"{{OUT}}/{{name}}.npz", *arrays)

report = {{}}
mesh1 = make_mesh((4, 2), ("data", "model"))
mesh2 = make_mesh((2, 2), ("data", "model"))
t1 = Trainer(cfg, TrainerConfig(**TC), mesh=mesh1, params=params0(),
             device="cpu")
t1.run()
report["t1_placements"] = [str(p.placements) for p in
                           tree_leaves(t1.state["params"])]
st2 = reshard_state(t1.state, mesh2)
report["st2_none"] = st2 is None
t2 = None
if st2 is not None:
    t2 = Trainer(cfg, TrainerConfig(**dict(TC, steps=10, ckpt_every=10,
                                            ckpt_dir=OUT + "/ck_trainer")),
                 mesh=mesh2, device="cpu")
    t2.state = st2
    t2.run()
    report["t2_losses"] = [h["loss"] for h in t1.history + t2.history]
    report["t2_step"] = int(t2.state["step"])
    state = {{k: t2.state[k] for k in ("step", "params", "m", "v")}}
    final = {{k: whole(state[k]) for k in ("params", "m", "v")}}
    if RANK == 0:
        dump("elastic", *final["params"])
        dump("elastic_m", *final["m"])
        dump("elastic_v", *final["v"])
    # the sharded save; rank 0 writes
    ckpt.save(OUT + "/ck_sharded", state)
    with sh.use_mesh_rules(mesh2):
        shard = sh.param_shardings(state["params"], mesh2)
    like = tree_map(lambda t: torch.empty(0), state)
    got = ckpt.restore(OUT + "/ck_sharded", like,
                       shardings={{"params": shard, "m": shard, "v": shard}})
    report["restore_placements"] = all(
        g.placements == s.placements and g.placements == t.placements
        for g, s, t in zip(tree_leaves(got["params"]), tree_leaves(shard),
                           tree_leaves(state["params"])))
    report["restore_bits"] = all(
        np.array_equal(a, b) for k in ("params", "m", "v")
        for a, b in zip(whole(got[k]), final[k]))
    report["restore_step"] = int(got["step"])
    # the trainer's own checkpoint (rank 0 wrote it, the reference layout)
    t4 = Trainer(cfg, TrainerConfig(**dict(TC, steps=10,
                                            ckpt_dir=OUT + "/ck_trainer")),
                 mesh=mesh2, device="cpu")
    report["t4_restored"] = t4.restore_latest()
    report["t4_step"] = int(t4.state["step"])
    report["t4_bits"] = all(
        np.array_equal(a, b) for k in ("params", "m", "v")
        for a, b in zip(whole(t4.state[k]), final[k]))
# grow back onto (4, 2): ranks 4-7 take rank 0's state
st3 = reshard_state(None if t2 is None else t2.state, mesh1)
if RANK == 5:
    dump("grown", *whole(st3["params"]))
else:
    whole(st3["params"])
# the uninterrupted (4, 2) run
t3 = Trainer(cfg, TrainerConfig(**dict(TC, steps=10)), mesh=mesh1,
             params=params0(), device="cpu")
t3.run()
report["t3_losses"] = [h["loss"] for h in t3.history]
final3 = whole(t3.state["params"])
if RANK == 0:
    dump("straight", *final3)
# granite (router loss) and mamba on the (2, 2) mesh
if mesh2.get_coordinate() is not None:
    for arch in SMALL_ARCHS:
        c = get_config(arch).reduced()
        tr = Trainer(c, TrainerConfig(**dict(TC, steps=SMALL_STEPS)),
                     mesh=mesh2, params=lm.init(1, c, device="cpu"),
                     device="cpu")
        tr.run()
        report[arch] = {{k: [h[k] for h in tr.history]
                        for k in ("loss", "aux_loss", "grad_norm")}}
        final = whole(tr.state["params"])
        if RANK == 0:
            dump(arch, *final)
with open(f"{{OUT}}/report{{RANK}}.json", "w") as f:
    json.dump(report, f)
"""


def _one_process(cfg, params, steps):
    tr = Trainer(cfg, TrainerConfig(**dict(TC, steps=steps)), params=params,
                 device="cpu")
    tr.run()
    return tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8-rank spawn, the reference's (4, 2) run and the one-process
    runs, at once."""
    out = tmp_path_factory.mktemp("mesh_train")
    cfg = get_config("smollm-360m").reduced()
    init = jax.tree_util.tree_map(
        np.asarray, j_lm.init(jax.random.PRNGKey(0),
                              j_get_config("smollm-360m").reduced()))
    with open(out / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
         repr(TC)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        code = _RANKS.format(tc=repr(TC), small=repr(SMALL_ARCHS),
                             steps=SMALL_STEPS)
        spawn = {}

        def ranks():
            try:
                spawn["out"] = run_ranks(code, 8, out, timeout=TIMEOUT)
            except AssertionError as e:     # handed to the test's thread
                spawn["err"] = e

        th = threading.Thread(target=ranks)
        th.start()
        one = {"smollm-360m": _one_process(
            cfg, lm.params_from_reference(init, cfg, device="cpu"), 10)}
        for arch in SMALL_ARCHS:
            c = get_config(arch).reduced()
            one[arch] = _one_process(c, lm.init(1, c, device="cpu"),
                                     SMALL_STEPS)
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

    def leaves(name):
        z = np.load(out / f"{name}.npz")
        return [z[f"arr_{i}"] for i in range(len(z.files))]

    return {"out": out, "one": one, "reference": reference,
            "reports": [json.load(open(out / f"report{r}.json"))
                        for r in range(8)],
            "leaves": leaves}


def _worst(got, want):
    """The largest |got - want| and whether every leaf is within the
    bound."""
    worst, ok = 0.0, True
    for a, b in zip(got, want, strict=True):
        b = np.asarray(b)
        worst = max(worst, float(np.abs(a - b).max()))
        ok &= bool(np.allclose(a, b, rtol=RTOL, atol=ATOL))
    return worst, ok


def _params(tr):
    return [t.detach().numpy() for t in tree_leaves(tr.state["params"])]


def test_elastic_reshard_matches_the_uninterrupted_mesh_run(runs):
    r0 = runs["reports"][0]
    assert r0["t2_step"] == 10 and not r0["st2_none"]
    assert [r["st2_none"] for r in runs["reports"]] == [False] * 4 + [True] * 4
    # the (4, 2) mesh shards the rules' dims: e.g. the MLP over model
    assert any("Shard(dim=1)" in p for p in r0["t1_placements"])
    worst, ok = _worst(runs["leaves"]("elastic"), runs["leaves"]("straight"))
    print(f"elastic vs uninterrupted: max|diff| {worst:.3e}")
    assert ok, worst


def test_elastic_reshard_matches_the_one_process_run(runs):
    one = runs["one"]["smollm-360m"]
    for name in ("elastic", "straight"):
        worst, ok = _worst(runs["leaves"](name), _params(one))
        print(f"{name} vs one process: max|diff| {worst:.3e}")
        assert ok, (name, worst)
    # history's losses are the one-process run's (sums and counts, not
    # means of means)
    want = [h["loss"] for h in one.history]
    for key in ("t2_losses", "t3_losses"):
        np.testing.assert_allclose(runs["reports"][0][key], want, rtol=RTOL,
                                   atol=ATOL)


def test_elastic_reshard_matches_the_reference_mesh_run(runs):
    """Against the reference's 10-step (4, 2) run from the same params: the
    port's params laid out as the reference's."""
    cfg = get_config("smollm-360m").reduced()
    ref = runs["reference"]
    want = [a for _, a in ckpt.checkpoint._flatten(ref["params"])]
    for name in ("elastic", "straight"):
        got = [t.numpy() for _, t in ckpt.checkpoint._flatten(
            lm.to_reference_layout(_one_layout(runs, name, cfg), cfg))]
        worst, ok = _worst(got, want)
        print(f"{name} vs the reference's (4, 2) run: max|diff| "
              f"{worst:.3e}")
        assert ok, (name, worst)
    np.testing.assert_allclose(runs["reports"][0]["t3_losses"],
                               ref["losses"], rtol=RTOL, atol=ATOL)


def _one_layout(runs, name, cfg):
    """The saved leaves (in ``tree_leaves`` order) as the port's params
    tree."""
    like = lm.init(0, cfg, device="cpu")
    by_path = dict(zip((p for p, _ in ckpt.checkpoint._flatten(like)),
                       runs["leaves"](name), strict=True))
    return tree_map_with_path(lambda p, _: torch.from_numpy(by_path[p]),
                              like)


def test_reshard_grows_back_bit_equal(runs):
    """(2, 2) -> (4, 2): a rank outside the shrunken mesh gets rank 0's
    state, the params bit-equal."""
    for a, b in zip(runs["leaves"]("grown"), runs["leaves"]("elastic"),
                    strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_small_mesh_steps_match_the_one_process_run(runs, arch):
    """3 steps on the (2, 2) mesh: losses (and granite's router loss, its
    load-balance means over the global batch), grad norms and params
    within the bound of the one-process run."""
    one = runs["one"][arch]
    got = runs["reports"][0][arch]
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], [h[k] for h in one.history],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert (np.asarray(got["aux_loss"]) > 0).all() == (arch != "mamba2-2.7b")
    worst, ok = _worst(runs["leaves"](arch), _params(one))
    print(f"{arch}: max|diff| {worst:.3e}")
    assert ok, worst


def test_sharded_save_is_the_one_process_save(runs, tmp_path):
    """The (2, 2) mesh's sharded save writes the bytes of a one-process
    save of the same values; ``restore(shardings=)`` puts every leaf back
    with its placements and bits; the mesh trainer's own checkpoint (rank
    0 writes, in the reference's layout) restores bit-equal."""
    out = runs["out"]
    cfg = get_config("smollm-360m").reduced()
    state = {"step": torch.tensor(10, dtype=torch.int32),
             **{k: _one_layout(runs, name, cfg) for k, name in (
                 ("params", "elastic"), ("m", "elastic_m"),
                 ("v", "elastic_v"))}}
    ckpt.save(str(tmp_path), state)
    step = "step_0000000010"
    names = sorted(os.listdir(tmp_path / step))
    assert names == sorted(os.listdir(out / "ck_sharded" / step))
    for n in names:
        assert (out / "ck_sharded" / step / n).read_bytes() == \
            (tmp_path / step / n).read_bytes(), n
    for r in runs["reports"][:4]:
        assert r["restore_placements"] and r["restore_bits"]
        assert r["restore_step"] == 10
        assert r["t4_restored"] and r["t4_step"] == 10 and r["t4_bits"]


def test_launcher_trains_on_a_mesh_and_refuses_a_wrong_one(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2
    --device cpu`` trains 2 steps of reduced smollm-360m; ``--mesh 2x3``
    on 4 ranks is refused with a message.  Both at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)

    def start(mesh, log):
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
             "--mesh", mesh, "--device", "cpu", "--steps", "2", "--batch",
             "4", "--seq-len", "16"], env=env, cwd=tmp_path,
            stdout=log, stderr=subprocess.STDOUT)

    with open(tmp_path / "ok.log", "w+") as ok_log, \
            open(tmp_path / "bad.log", "w+") as bad_log:
        procs = [start("2x2", ok_log), start("2x3", bad_log)]
        try:
            for p in procs:
                p.wait(timeout=TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ok_log.seek(0)
        bad_log.seek(0)
        ok, bad = ok_log.read(), bad_log.read()
    assert procs[0].returncode == 0, ok[-4000:]
    assert "mesh 2x2 (data x model): 4 ranks, gloo" in ok
    assert ok.count("step      2 loss") == 1, ok[-4000:]
    assert procs[1].returncode != 0
    assert "--mesh 2x3: 6 ranks, but torchrun started 4" in bad, bad[-4000:]
