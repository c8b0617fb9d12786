"""The port's CnnEngine, launcher and package boundaries, on the CPU.

Served logits must bit-match the port's own ``alexnet.apply`` on the same
padded bucket batch, so batching and padding never change what a user
gets back (the port's counterpart of tests/test_serving_cnn.py).  The
engine runs the reduced config on route ``pallas``, whose kernel wrappers
take their plain versions on the CPU.  Images are made with numpy from a
seed.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv import direct  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.serving import (CnnEngine, CnnServeConfig,  # noqa: E402
                                 FaultInjector, FaultSpec, ImageRequest,
                                 bucket_sizes)
from repro_torch.serving.faults import TransientLaunchError  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(get_config("alexnet").reduced(), use_pallas=True)
    return cfg, alexnet.init(0, cfg, device="cpu")


def _images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.in_channels)
    ).astype(np.float32)


def _engine(cfg, params, *, faults=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("retry_backoff_ms", 0.01)
    return CnnEngine(cfg, CnnServeConfig(**kw), params=params, faults=faults,
                     device="cpu")


def _apply_at_bucket(params, cfg, reqs_by_uid, req):
    """The port's apply on the exact padded batch ``req`` was served in."""
    x = np.zeros((req.served_bucket, *req.image.shape), np.float32)
    for row, uid in enumerate(req.served_group):
        x[row] = reqs_by_uid[uid].image
    return alexnet.apply(params, cfg, torch.from_numpy(x)).numpy()


def _assert_bitmatch(params, cfg, reqs):
    by_uid = {r.uid: r for r in reqs}
    for r in reqs:
        ref = _apply_at_bucket(params, cfg, by_uid, r)[r.served_row]
        assert np.array_equal(r.logits, ref), np.abs(r.logits - ref).max()
        assert r.label == int(ref.argmax())


def test_bucket_sizes():
    assert bucket_sizes(1) == (1,)
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(6) == (1, 2, 4, 6)


@pytest.mark.parametrize("n_req,max_batch,bucket", [
    (1, 4, 1),     # a single request
    (3, 4, 4),     # a partial bucket: 3 padded to 4
    (4, 4, 4),     # a full max_batch bucket
])
def test_served_logits_bitmatch_apply(served, n_req, max_batch, bucket):
    cfg, params = served
    eng = _engine(cfg, params, max_batch=max_batch)
    reqs = [ImageRequest(image=im) for im in _images(cfg, n_req, n_req)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done and r.served_bucket == bucket for r in reqs)
    assert eng.bucket_counts == {bucket: 1}
    _assert_bitmatch(params, cfg, reqs)
    # rows of one batch are independent: padding rows change nothing
    alone = alexnet.apply(params, cfg, torch.from_numpy(
        np.stack([r.image for r in reqs]))).numpy()
    np.testing.assert_allclose(np.stack([r.logits for r in reqs]), alone,
                               rtol=1e-5, atol=1e-6)


def test_counters_and_accounting(served):
    cfg, params = served
    eng = _engine(cfg, params)
    reqs = [ImageRequest(image=im) for im in _images(cfg, 6, seed=9)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    s = eng.stats()
    assert s["images_completed"] == 6
    assert eng.sched.submitted == eng.sched.completed == 6
    assert eng.sched.occupancy == 0 and eng.sched.idle
    assert s["batches_run"] == 2 and s["bucket_counts"] == {2: 1, 4: 1}
    assert s["avg_occupancy"] == pytest.approx(3.0)
    assert s["imgs_per_s"] > 0
    lat = s["latency_ms"]
    assert len(eng.latency) == 6 and 0 < lat["p50"] <= lat["p99"]
    acc = eng.accounting()
    assert acc["balanced"] and acc["in_flight"] == 0
    assert acc["submitted"] == acc["completed"] == 6


def test_mixed_arrival_retires_each_request_its_logits(served):
    cfg, params = served
    eng = _engine(cfg, params, max_batch=2)
    imgs = _images(cfg, 7, seed=3)
    order = [4, 0, 6, 2, 5, 1, 3]
    reqs = [ImageRequest(image=imgs[i]) for i in order]
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert sorted(eng.bucket_counts.items()) == [(1, 1), (2, 3)]
    # FIFO admission: the first tick staged (0, 1) and (2,), the rest
    # followed in submission order
    uids = [r.uid for r in reqs]
    assert {r.served_group for r in reqs} == {
        tuple(uids[0:2]), tuple(uids[2:3]), tuple(uids[3:5]),
        tuple(uids[5:7])}
    _assert_bitmatch(params, cfg, reqs)


def test_transient_failures_retry_and_degrade_to_direct(served):
    """Repeated launch failures flip the bucket onto the ``direct`` route;
    what is served there bit-matches the direct route's apply, and every
    request is accounted for."""
    cfg, params = served
    inj = FaultInjector(0, {"launch.transient": FaultSpec(at=(0, 1))})
    eng = _engine(cfg, params, faults=inj, degrade_threshold=2,
                  quarantine_threshold=10)
    reqs = [ImageRequest(image=im, retries=3)
            for im in _images(cfg, 3, seed=8)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    s = eng.stats()
    assert s["degraded_buckets"] == [4] and s["batches_failed"] == 2
    ev, = eng.degradations
    assert ev["from"] == "pallas" and ev["to"] == "direct"
    cfg_d = dataclasses.replace(cfg, use_winograd=False, use_pallas=False)
    _assert_bitmatch(params, cfg_d, reqs)
    assert eng.accounting()["balanced"]


@pytest.mark.parametrize("error", [
    build.KernelError("conv_direct: CUDA launch failed with cudaError_t 1"),
    ValueError("conv_direct: every tensor must be a contiguous float32"),
])
def test_kernel_errors_propagate_and_never_degrade(served, monkeypatch,
                                                   error):
    """A kernel that fails to build or launch, or refuses its inputs, is a
    fault of the datapath under test: it propagates out of the engine and
    never moves the bucket onto the ``direct`` route."""
    cfg, params = served

    def fail(*args, **kw):
        raise error

    monkeypatch.setattr(direct, "conv2d_direct_plain", fail)
    eng = _engine(cfg, params, degrade_threshold=1)
    for im in _images(cfg, 2, seed=5):
        eng.submit(ImageRequest(image=im))
    with pytest.raises(type(error), match="conv_direct"):
        eng.run_until_done()
    s = eng.stats()
    assert s["degradations"] == [] and s["degraded_buckets"] == []
    assert s["batches_failed"] == 0 and s["images_completed"] == 0


def test_device_oom_is_a_transient_launch_failure(served, monkeypatch):
    """Out of device memory is the one real launch error the retry ladder
    takes: the group is re-queued and served on the same route."""
    cfg, params = served
    plain = direct.conv2d_direct_plain
    calls = []

    def oom_once(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return plain(*args, **kw)

    monkeypatch.setattr(direct, "conv2d_direct_plain", oom_once)
    eng = _engine(cfg, params)
    reqs = [ImageRequest(image=im) for im in _images(cfg, 2, seed=6)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    s = eng.stats()
    assert all(r.done for r in reqs) and s["batches_failed"] == 1
    assert s["degradations"] == [] and eng.images_retried == 2
    monkeypatch.setattr(direct, "conv2d_direct_plain", plain)
    _assert_bitmatch(params, cfg, reqs)


def test_build_failures_raise_kernel_error(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(build.KernelError, match="nvcc not found"):
        build._nvcc()
    with pytest.raises(build.KernelError, match="cudaError_t 719"):
        build.check(719, "conv_winograd")
    build.check(0, "conv_winograd")


def test_launcher_reports_degradation(monkeypatch, capsys):
    """Served images a degraded bucket ran on the ``direct`` route are
    named in the launcher's report, never passed off as the kernels'."""
    def transient(*args, **kw):
        raise TransientLaunchError("launch failed")

    monkeypatch.setattr(direct, "conv2d_direct_plain", transient)
    serve.main(["--route", "pallas", "--requests", "2", "--max-batch", "2",
                "--retries", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 2/2" in out
    assert ("DEGRADED bucket 2: pallas -> direct after 3 launch failures"
            in out)


def test_nonfinite_rows_are_never_served(served):
    """A corrupted staging buffer poisons the logits through the kernels'
    plain versions; the screen retries the row from the pristine image."""
    cfg, params = served
    inj = FaultInjector(0, {"stage.corrupt": FaultSpec(at=(0,))})
    eng = _engine(cfg, params, faults=inj)
    reqs = [ImageRequest(image=im) for im in _images(cfg, 2, seed=4)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done and np.isfinite(r.logits).all() for r in reqs)
    assert eng.accounting()["screen_nonfinite"] >= 1
    assert eng.images_retried >= 1
    _assert_bitmatch(params, cfg, reqs)


def test_export_state_is_numpy(served):
    cfg, params = served
    state = _engine(cfg, params).export_state()["params"]
    assert isinstance(state["conv1"]["w"], np.ndarray)
    back = alexnet.params_from_numpy(state, device="cpu")
    assert all(torch.equal(back[n]["w"], params[n]["w"]) for n in params)


@pytest.mark.parametrize("scfg,faults", [
    (dict(data_parallel=True), None), (dict(verify_slabs=True), None),
    ({}, {"slab.bitflip": FaultSpec(rate=1.0)})])
def test_unported_engine_options_raise(served, scfg, faults):
    cfg, params = served
    inj = FaultInjector(0, faults) if faults else None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CnnEngine(cfg, CnnServeConfig(**scfg), params=params, faults=inj,
                  device="cpu")


def test_default_device_is_the_card(served, monkeypatch):
    """Entry points default to ``device="cuda"`` and raise without a card;
    they never fall back to the CPU."""
    cfg, params = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CnnEngine(cfg, CnnServeConfig(), params=params)
    with pytest.raises(RuntimeError, match="is_available"):
        alexnet.init(0, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        alexnet.params_from_numpy(alexnet.params_to_numpy(params))
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--requests", "1"])


def test_launcher_serves_on_the_cpu(capsys):
    serve.main(["--route", "pallas", "--requests", "3", "--max-batch", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "conv1=cuda-direct" in out and "conv5=cuda-winograd" in out
    assert "completed 3/3" in out and "balanced=yes" in out


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_chip_smoke_alone_fails(tmp_path):
    """Without the repository around it (or without a card) the smoke
    script exits nonzero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
