"""Supervised multi-process image serving of the port on the CPU: the
worker protocol, the worker against the JAX package's worker, and the
reference's spawned-process scenarios (``tests/test_supervisor.py``).

The port's workers serve reduced AlexNet at image 67 (at the reference's
35 the port's ``init`` raises: ROADMAP Queue 3) on route ``pallas`` (the
kernels' plain versions here), with ``device="cpu"``.  The invariant under
test everywhere::

    submitted == completed + shed + expired          (fleet-wide, drained)

across worker kills, stalls and respawns, with every checked served logit
bit-equal to ``apply`` at the exact padded bucket it was served in.  Where
a port worker and a reference worker restore the same reference
checkpoint and serve the same images, their statuses and provenance are
equal and their logits agree within ``1e-4 * max|logit|`` in f32 and
``5e-2 * max|logit|`` for bf16 VGG-16.
"""
import dataclasses
import multiprocessing as mp
import os
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as j_serving  # noqa: E402
from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.serving import (CnnServeConfig, FaultSpec,  # noqa: E402
                                 ImageRequest, Supervisor, SupervisorConfig,
                                 WorkerDead, WorkerModel, WorkerSpec,
                                 worker_main)

IMAGE = 67


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Spawned workers inherit this: one torch thread each, beside the
    test runner's other processes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(get_config("alexnet").reduced(),
                              image_size=IMAGE, use_pallas=True)
    scfg = CnnServeConfig(max_batch=2, staging_depth=2,
                          retry_backoff_ms=0.5)
    return cfg, scfg


def _images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.in_channels)
    ).astype(np.float32)


def _sup(cfg, scfg, models=None, **kw):
    sup_kw = {"device": "cpu"}
    for k in ("ckpt_dir", "chaos", "chaos_workers", "seed", "device"):
        if k in kw:
            sup_kw[k] = kw.pop(k)
    cfg_kw = dict(n_workers=2, max_restarts=2, checkpoint_on_start=False,
                  heartbeat_timeout_ms=500.0)
    cfg_kw.update(kw)
    models = models or (WorkerModel("alexnet", cfg, scfg,
                                    seed=sup_kw.get("seed", 0)),)
    return Supervisor(models, SupervisorConfig(**cfg_kw), **sup_kw)


def _drain_ok(sup, n_submitted):
    acc = sup.run_until_done(max_steps=2000)
    assert acc["balanced"] and acc["in_flight"] == 0, acc
    assert acc["submitted"] == n_submitted
    assert acc["submitted"] == (acc["completed"] + acc["shed"]
                                + acc["expired"]), acc
    return acc


def _await_respawn(sup, name, timeout_s=120.0):
    """Pump until the respawned worker's ready handshake lands."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        sup.step()
        h = sup.workers[name]
        if h.alive:
            return h
        time.sleep(0.05)
    raise AssertionError(f"{name} never came back")


# -- the protocol, in a thread ------------------------------------------------
class _Thread:
    """``worker_main`` of either package in a thread, over a Pipe."""

    def __init__(self, main, spec):
        self.conn, child = mp.Pipe()
        self.seq = 0
        self.t = threading.Thread(target=main, args=(child, spec),
                                  daemon=True)
        self.t.start()
        self.ready = self.conn.recv()

    def call(self, **msg):
        self.seq += 1
        self.conn.send(dict(msg, seq=self.seq))
        assert self.conn.poll(120), msg
        reply = self.conn.recv()
        assert reply["seq"] == self.seq
        return reply

    def serve(self, model, images, uid0=1000):
        for i, im in enumerate(images):
            assert self.call(op="submit", model=model, uid=uid0 + i,
                             image=im)["accepted"]
        for _ in range(100):
            if self.call(op="step", n=1)["drained"]:
                break
        return {r["uid"]: r for r in self.call(op="retire_batch")["results"]}

    def close(self):
        assert self.call(op="shutdown")["bye"]
        self.t.join(timeout=10)
        assert not self.t.is_alive()


def test_worker_protocol_every_op(small, tmp_path):
    cfg, scfg = small
    w = _Thread(worker_main, WorkerSpec(
        "w0", (WorkerModel("alexnet", cfg, scfg),),
        ckpt_dir=str(tmp_path), device="cpu"))
    assert w.ready["ok"] and w.ready["restored"] == {"alexnet": None}
    assert w.ready["device"] == "cpu" and w.ready["device_name"] == "cpu"
    assert set(w.ready["launches"]) >= {"conv_direct", "conv_winograd",
                                        "conv_winograd_fused", "bfp_matmul"}
    assert w.ready["degradations"] == {"alexnet": []}
    out = w.serve("alexnet", _images(cfg, 3))
    assert sorted(out) == [1000, 1001, 1002]
    for rec in out.values():
        assert rec["status"] == "done" and rec["bucket"] in (1, 2)
        assert isinstance(rec["logits"], np.ndarray)
        assert rec["logits"].dtype == np.float32
        assert rec["uid"] in rec["group"]
    hb = w.call(op="heartbeat")
    assert hb["alive"] and hb["inflight"] == 0
    assert hb["accounting"]["alexnet"]["completed"] == 3
    assert hb["device_name"] == "cpu" and hb["degradations"] == {
        "alexnet": []}
    rep = w.call(op="checkpoint")
    assert rep["step"] == 1 and ckpt.verify_step(
        str(tmp_path / "alexnet"), 1) == (True, [])
    assert w.call(op="checkpoint")["step"] == 2
    t0 = time.perf_counter()
    assert w.call(op="stall", delay_ms=50.0)["stalled_ms"] == 50.0
    assert time.perf_counter() - t0 >= 0.05
    assert "unknown op" in w.call(op="bogus")["error"]
    w.close()


def test_worker_failed_build_reports_and_raises(small):
    cfg, scfg = small
    bad = dataclasses.replace(cfg, image_size=35)   # init raises there
    conn, child = mp.Pipe()
    errors = []

    def run():
        try:
            worker_main(child, WorkerSpec("w0", (WorkerModel("a", bad,
                                                             scfg),),
                                          device="cpu"))
        except Exception as e:      # the thread's own exit
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    ready = conn.recv()
    t.join(timeout=30)
    assert not ready["ok"] and ready["error"] and errors


# -- against the reference's worker -----------------------------------------
CASES = {"alexnet-f32": ("alexnet", "float32", 1e-4),
         "vgg16-bf16": ("vgg16", "bfloat16", 5e-2)}


@pytest.mark.parametrize("case", CASES)
def test_worker_matches_the_reference_worker(tmp_path, case):
    """Both workers restore one reference checkpoint (f32 leaves: the
    reference cannot load its own bf16 ones; a bf16 model's values are
    bf16-representable and the port's worker rounds them to its dtype,
    exactly) and serve the same images: equal statuses and provenance,
    logits within the case's tolerance."""
    name, dtype, tol = CASES[case]
    j_cfg = dataclasses.replace(j_get_config(name).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype,
                              use_pallas=True)
    assert cfg.image_size == j_cfg.image_size
    p = j_alexnet.init(jax.random.PRNGKey(3), j_cfg)
    np_p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    j_ckpt.save(str(tmp_path / name), {"step": 1, "params": np_p})
    j_w = _Thread(j_serving.worker.worker_main, j_serving.WorkerSpec(
        "j", (j_serving.WorkerModel(name, j_cfg, j_serving.CnnServeConfig(
            max_batch=2)),), ckpt_dir=str(tmp_path)))
    w = _Thread(worker_main, WorkerSpec(
        "t", (WorkerModel(name, cfg, CnnServeConfig(max_batch=2)),),
        ckpt_dir=str(tmp_path), device="cpu"))
    assert j_w.ready["restored"] == w.ready["restored"] == {name: 1}
    images = _images(cfg, 5, seed=4)
    j_out, out = j_w.serve(name, images), w.serve(name, images)
    j_w.close()
    w.close()
    assert sorted(out) == sorted(j_out) == list(range(1000, 1005))
    for uid, rec in out.items():
        ref = j_out[uid]
        for k in ("status", "bucket", "row", "group", "label"):
            assert rec[k] == ref[k], (uid, k)
        want = np.asarray(ref["logits"], np.float32)
        np.testing.assert_allclose(rec["logits"], want, rtol=0,
                                   atol=tol * np.abs(want).max())
    # the port's served params are the checkpoint's, in the model's dtype
    back = alexnet.params_from_numpy(np_p, device="cpu", dtype=dtype)
    restored = ckpt.restore(str(tmp_path / name), {"step": 0,
                                                   "params": back})
    assert all(torch.equal(restored["params"][l][k].to(back[l][k].dtype),
                           back[l][k]) for l in back for k in back[l])


# -- the reference's spawned-process scenarios --------------------------------
def test_protocol_roundtrip_heartbeat_and_bitmatch(small, tmp_path):
    cfg, scfg = small
    sup = _sup(cfg, scfg, n_workers=1, ckpt_dir=str(tmp_path / "ck"))
    with sup:
        reqs = [ImageRequest(image=im) for im in _images(cfg, 5)]
        for r in reqs:
            assert sup.submit("alexnet", r)
        _drain_ok(sup, 5)
        assert all(r.done for r in reqs)
        sup.step()          # the heartbeat's snapshot trails by one pump
        h = sup.workers["w0"]
        assert h.last_accounting["alexnet"]["completed"] == 5
        assert h.device_name == "cpu"
        par = sup.verify_bit_parity(uids=[r.uid for r in reqs])
        assert par["checked"] == 5 and par["mismatched"] == 0, par
        assert all(r.served_bucket in (1, 2) for r in reqs)
        assert all(r.uid in r.served_group for r in reqs)
        rep = sup.checkpoint()
        d = os.path.join(str(tmp_path / "ck"), "alexnet")
        ok, problems = ckpt.verify_step(d, rep["step"])
        assert ok, problems
        assert ckpt.latest_intact_step(d) == rep["step"]


def test_stall_trips_heartbeat_but_worker_survives(small):
    cfg, scfg = small
    sup = _sup(cfg, scfg, n_workers=2,
               heartbeat_timeout_ms=150.0, miss_threshold=6,
               chaos={"worker.stall": FaultSpec(at=(1,), delay_ms=350.0,
                                                limit=1)},
               chaos_workers=("w0",))
    with sup:
        reqs = [ImageRequest(image=im) for im in _images(cfg, 8)]
        for r in reqs[:4]:
            sup.submit("alexnet", r)
        sup.step()                          # opportunity 0: no stall
        for r in reqs[4:]:
            sup.submit("alexnet", r)
        acc = _drain_ok(sup, 8)
        assert acc["completed"] == 8
        h = sup.workers["w0"]
        assert h.injector.summary()["worker.stall"]["fired"] == 1
        assert h.monitor.failures_total >= 1      # the miss was recorded
        assert not h.deaths and h.restarts == 0   # ...but no kill


def test_mid_flight_kill_fails_over_zero_lost_bit_identical(small):
    cfg, scfg = small
    sup = _sup(cfg, scfg, n_workers=2)
    with sup:
        reqs = [ImageRequest(image=im, deadline_ms=60_000.0)
                for im in _images(cfg, 10)]
        for r in reqs:
            sup.submit("alexnet", r)
        assert len(sup.workers["w0"].inflight) > 0
        sup.kill_worker("w0", "test-kill")
        acc = _drain_ok(sup, 10)
        assert acc["completed"] == 10 and acc["failed_over"] > 0
        par = sup.verify_bit_parity()
        assert par["checked"] == sup.failed_over
        assert par["mismatched"] == 0, par
        assert "death" in [e["event"] for e in sup.events]
        assert sup.workers["w0"].restarts == 1
        all_par = sup.verify_bit_parity(uids=[r.uid for r in reqs])
        assert all_par == {"checked": 10, "mismatched": 0, "bad_uids": []}


def test_crash_consistent_restart_restores_intact_checkpoint(small,
                                                             tmp_path):
    cfg, scfg = small
    ckpt_dir = str(tmp_path / "ck")
    sup = _sup(cfg, scfg, n_workers=2, ckpt_dir=ckpt_dir,
               checkpoint_on_start=True)
    with sup:
        assert sup.checkpoint()["step"] == 2    # start() wrote step 1
        d = os.path.join(ckpt_dir, "alexnet")
        leaves = [f for f in os.listdir(os.path.join(d, "step_0000000002"))
                  if f.endswith(".npy")]
        os.remove(os.path.join(d, "step_0000000002", leaves[0]))

        reqs = [ImageRequest(image=im, deadline_ms=120_000.0)
                for im in _images(cfg, 4)]
        for r in reqs:
            sup.submit("alexnet", r)
        sup.kill_worker("w0", "test-kill")
        _drain_ok(sup, 4)
        h = _await_respawn(sup, "w0")
        assert h.restored == {"alexnet": 1}, h.restored
        sup.workers["w1"].alive = False   # route fresh traffic to w0 only
        more = [ImageRequest(image=im) for im in _images(cfg, 3, seed=9)]
        for r in more:
            assert sup.submit("alexnet", r)
        sup.workers["w1"].alive = True
        acc = sup.run_until_done(max_steps=2000)
        assert acc["balanced"] and all(r.done for r in more)
        with pytest.warns(UserWarning, match="failed integrity"):
            par = sup.verify_bit_parity(uids=[r.uid for r in more])
        assert par["checked"] == 3 and par["mismatched"] == 0, par


def test_accounting_invariant_under_mixed_process_chaos(small):
    cfg, scfg = small
    sup = _sup(cfg, scfg, n_workers=2, seed=3,
               heartbeat_timeout_ms=200.0,
               chaos={"worker.crash": FaultSpec(at=(3,), limit=1),
                      "worker.stall": FaultSpec(rate=0.15, delay_ms=250.0,
                                                limit=2)},
               chaos_workers=("w0", "w1"))
    with sup:
        rng = np.random.default_rng(3)
        submitted = 0
        for burst in (1, 2, 1, 2, 2, 1, 2, 2):
            for _ in range(burst):
                dl = 25.0 if rng.uniform() < 0.3 else 60_000.0
                sup.submit("alexnet", ImageRequest(
                    image=rng.standard_normal(
                        (cfg.image_size, cfg.image_size,
                         cfg.in_channels)).astype(np.float32),
                    deadline_ms=dl, retries=2))
                submitted += 1
            sup.step()
        acc = _drain_ok(sup, submitted)
        assert acc["completed"] > 0
        fired = sum((h.injector.summary().get("worker.crash", {})
                     .get("fired", 0)) for h in sup.workers.values()
                    if h.injector)
        assert fired >= 1
        done = [u for u, (m, r) in sup.requests.items() if r.done]
        par = sup.verify_bit_parity(uids=done)
        assert par["checked"] == len(done) and par["mismatched"] == 0, par


def test_two_model_worker_restarts_from_a_bf16_checkpoint(tmp_path):
    """Each worker serves f32 AlexNet and bf16 VGG-16; a second
    checkpoint is torn (one bf16 leaf's byte flipped), w0 is killed, and
    the respawn restores step 1 of both models, bf16 leaves bit-equal,
    and serves both bit-equal to ``apply``."""
    alex = dataclasses.replace(get_config("alexnet").reduced(),
                               image_size=IMAGE, use_pallas=True)
    vgg = dataclasses.replace(get_config("vgg16").reduced(),
                              dtype="bfloat16", use_pallas=True)
    scfg = CnnServeConfig(max_batch=2, staging_depth=2)
    models = (WorkerModel("alexnet", alex, scfg, seed=0),
              WorkerModel("vgg16", vgg, scfg, seed=1))
    ckpt_dir = str(tmp_path / "ck")
    sup = _sup(None, None, models=models, ckpt_dir=ckpt_dir,
               checkpoint_on_start=True)
    with sup:
        assert sup.checkpoint()["step"] == 2
        torn = os.path.join(ckpt_dir, "vgg16", "step_0000000002",
                            "params__fc6__w.npy")
        with open(torn, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            b = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x01]))
        sup.kill_worker("w0", "test-kill")
        h = _await_respawn(sup, "w0")
        assert h.restored == {"alexnet": 2, "vgg16": 1}, h.restored
        sup.workers["w1"].alive = False   # serve through the respawn only
        reqs = [(m, ImageRequest(image=im))
                for m, c in (("alexnet", alex), ("vgg16", vgg))
                for im in _images(c, 3, seed=5)]
        for m, r in reqs:
            assert sup.submit(m, r)
        sup.workers["w1"].alive = True
        _drain_ok(sup, len(reqs))
        assert all(r.done for _, r in reqs)
        with pytest.warns(UserWarning, match="failed integrity"):
            par = sup.verify_bit_parity(uids=[r.uid for _, r in reqs])
        assert par == {"checked": 6, "mismatched": 0, "bad_uids": []}
    # the bf16 leaves of step 1 come back bit-equal to init(seed)'s
    want = alexnet.init(1, vgg, device="cpu")
    got = ckpt.restore(os.path.join(ckpt_dir, "vgg16"),
                       {"step": 0, "params": want}, step=1)
    assert all(got["params"][l][k].dtype == torch.bfloat16
               and torch.equal(got["params"][l][k].view(torch.int16),
                               want[l][k].view(torch.int16))
               for l in want for k in want[l])


def test_cuda_supervisor_without_a_card_never_serves_on_the_cpu(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is "
                    "test_torch_cuda.py's")
    cfg, scfg = small
    sup = _sup(cfg, scfg, n_workers=1, max_restarts=0, device="cuda")
    with pytest.raises(WorkerDead, match="is_available"):
        sup.start()
    h = sup.workers["w0"]
    assert not h.alive and h.retired and h.device_name is None
    assert sup.completed == 0 and not sup._live()
    assert h.proc is not None and not h.proc.is_alive()


def test_a_worker_on_the_wrong_device_is_a_spawn_failure(small):
    """A ready handshake that names the CPU where the card was asked for
    retires the attempt; the worker is never routed to."""
    cfg, scfg = small
    sup = _sup(cfg, scfg, n_workers=1, max_restarts=0, device="cuda")
    h = sup.workers["w0"]
    h.conn, child = mp.Pipe()
    child.send({"op": "ready", "ok": True, "worker": "w0", "pid": 1,
                "restored": {}, "device": "cpu", "device_name": "cpu",
                "launches": {}, "degradations": {}})
    assert not sup._finalize_ready(h, block=True)
    assert not h.alive and h.retired
    assert "not on cuda" in h.deaths[-1]
    assert not sup.submit("alexnet", ImageRequest(image=_images(cfg, 1)[0]))
    assert sup.accounting()["shed"] == 1


def test_launcher_serves_supervised_on_the_cpu(capsys):
    serve.main(["--arch", "alexnet", "--workers", "2", "--kill-worker",
                "--route", "pallas", "--requests", "8", "--max-batch", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 8/8" in out and "balanced=yes" in out
    assert "worker deaths: w0(operator:--kill-worker)" in out
    assert "worker w1: cpu restarts=0" in out
    if "failover bit-parity" in out:
        assert " 0 mismatched" in out
    # --data-parallel reaches each worker's engine (its mesh: the worker's
    # one device here)
    serve.main(["--arch", "alexnet", "--workers", "1", "--data-parallel",
                "--route", "pallas", "--requests", "4", "--max-batch", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 4/4" in out and "balanced=yes" in out
