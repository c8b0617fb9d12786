"""The port's example twins (``examples/*_torch.py``) on the CPU at small
sizes: each ``main(argv)`` with ``--device cpu`` prints its OK line, and
none of them imports JAX or the JAX package.  The AlexNet example's
analytical table is held to the reference's ``alexnet_throughput``."""
import ast
import importlib.util
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("quickstart_torch", "serve_batch_torch", "alexnet_winograd_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_loss_falls(capsys):
    history = _load("quickstart_torch").main(["--device", "cpu",
                                              "--steps", "20"])
    assert [h["step"] for h in history] == [10, 20]
    assert history[-1]["loss"] < history[0]["loss"]
    assert "quickstart OK" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ("alexnet", "smollm-360m"))
def test_serve_batch(arch, capsys):
    done = _load("serve_batch_torch").main(
        ["--arch", arch, "--requests", "4", "--device", "cpu"])
    assert done == 4
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serve_batch OK")
    if arch == "alexnet":
        assert "completed 4/4 requests" in out
    else:
        assert "completed 4/4 requests" in out and "tok/s" in out


def test_alexnet_winograd(capsys):
    from repro.core.dse import DLAConfig, alexnet_throughput
    got = _load("alexnet_winograd_torch").main(["--device", "cpu",
                                                "--steps", "20"])
    ref = alexnet_throughput(DLAConfig(c_vec=8, k_vec=48),
                             system_overhead=.16)
    assert got["throughput"] == ref
    out = capsys.readouterr().out.splitlines()
    table = [f"  model system throughput: {ref['img_per_s']:.0f} img/s"] + [
        f"  {l['name']:6s} act={l['act_gflops']:6.0f} GFLOPS  "
        f"eff={l['dsp_eff']*100:5.1f}%" for l in ref["layers"]]
    assert out[1:1 + len(table)] == table
    assert got["last_loss"] < got["first_loss"] and got["err"] < 1e-3
    assert out[-1] == "alexnet_winograd OK"


def _imports(path):
    names = []
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_twins_import_no_jax():
    """No twin names ``jax`` or ``repro`` in an import, and importing all
    three in a fresh interpreter loads neither."""
    for name in TWINS:
        for mod in _imports(os.path.join(ROOT, "examples", name + ".py")):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (name, mod)
    code = ("import importlib.util, sys\n"
            f"for n in {TWINS!r}:\n"
            "    s = importlib.util.spec_from_file_location(\n"
            f"        n, {os.path.join(ROOT, 'examples')!r} + '/' + n + '.py')\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
