"""The fleet registry and the live SLO plane of the PyTorch port against
the JAX package, on the CPU.

Ports of the reference's registry and ``arm_slo`` tests
(``tests/test_serve_fleet.py``, ``tests/test_fault_tolerance.py``) on the
reduced AlexNet and VGG-16.  Where both packages serve the same requests
(same parameters, carried over as numpy; same seeded faults; one
``VirtualClock`` advanced 1 ms a fleet step, so deadlines and back-offs
fall on the same steps), the port's accounting and bucket counts must
equal the JAX registry's exactly, and its logits agree within rtol 1e-4,
atol 1e-4 * max|logit| (``tests/test_torch_alexnet.py``'s bound).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

import repro.serving as j_serving  # noqa: E402
import repro_torch.serving as t_serving  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import alexnet as j_alexnet  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import alexnet  # noqa: E402
from repro_torch.serving import (DEGRADED, HEALTHY,  # noqa: E402
                                 QUARANTINED, CnnEngine, CnnServeConfig,
                                 DrainTimeout, FaultInjector, FaultSpec,
                                 ImageRequest, ModelRegistry, VirtualClock,
                                 derive_seed)

MODELS = ("alexnet", "vgg16")


@pytest.fixture(scope="module")
def fleet():
    """Both reduced models in both packages, with the reference's params
    (numpy) carried into the port."""
    out = {}
    for i, name in enumerate(MODELS):
        j_cfg = j_get_config(name).reduced()
        np_params = jax.tree_util.tree_map(
            np.asarray, j_alexnet.init(jax.random.PRNGKey(i), j_cfg))
        out[name] = (j_cfg, get_config(name).reduced(), np_params,
                     alexnet.params_from_numpy(np_params, device="cpu"))
    return out


def _images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.in_channels)
    ).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_arm_slo_on_live_engine(fleet):
    """The SLO plane attaches after a warm-up without losing the packed
    slabs or the counters, and detaches with ``arm_slo(None)``."""
    _, cfg, _, params = fleet["alexnet"]
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=2), params=params,
                    device="cpu")
    assert eng.policy is None and eng.admission is None
    for r in [ImageRequest(image=im) for im in _images(cfg, 2, seed=3)]:
        eng.submit(r)
    eng.run_until_done()
    packed = dict(eng._packed)
    launched = set(eng._launched)
    eng.arm_slo(50.0, dynamic_buckets=True, admission=True)
    assert eng.policy is not None and eng.admission is not None
    assert eng.scfg.slo_ms == 50.0 and eng.scfg.admission
    assert eng._packed == packed and all(
        eng._packed[b] is packed[b] for b in packed)
    assert eng._launched == launched
    assert eng.images_completed == 2
    eng.arm_slo(None)
    assert eng.policy is None and eng.admission is None


def test_arm_slo_admission_sheds_on_a_warm_engine(fleet):
    """Armed on a warm engine, admission control sheds by the service time
    it then observes, and every shed request is reported."""
    _, cfg, _, params = fleet["vgg16"]
    clock = VirtualClock()
    eng = CnnEngine(cfg, CnnServeConfig(max_batch=2), params=params,
                    clock=clock, device="cpu")
    eng.arm_slo(1.0, admission=True)
    eng.admission.observe_batch(1, 1.0)     # 1000 ms an image
    reqs = [ImageRequest(image=im) for im in _images(cfg, 3, seed=4)]
    admitted = [eng.try_submit(r) for r in reqs]
    assert admitted == [True, False, False]
    assert [r.shed for r in reqs] == [False, True, True]
    eng.run_until_done()
    s = eng.stats()
    assert s["images_shed"] == 2 and s["images_completed"] == 1
    assert s["shed_reasons"] == {"admission": 2}
    assert s["accounting"]["balanced"]


def test_registry_two_models_interleaved(fleet):
    """AlexNet and VGG-16 through one registry: each request's logits equal
    its own model's ``apply`` at the served bucket bit for bit, agree with
    the JAX registry serving the same requests, and the counts equal the
    JAX registry's."""
    regs = {"torch": ModelRegistry(slot_budget=16),
            "jax": j_serving.ModelRegistry(slot_budget=16)}
    for name in MODELS:
        j_cfg, cfg, np_params, params = fleet[name]
        regs["torch"].register(name, cfg, CnnServeConfig(max_batch=4),
                               params=params, device="cpu")
        regs["jax"].register(name, j_cfg, j_serving.CnnServeConfig(
            max_batch=4), params=np_params)
    imgs = {"alexnet": _images(fleet["alexnet"][1], 3, seed=10),
            "vgg16": _images(fleet["vgg16"][1], 2, seed=11)}
    reqs = {}
    for pkg, reg in regs.items():
        req_cls = (ImageRequest if pkg == "torch"
                   else j_serving.ImageRequest)
        rs = {n: [req_cls(image=im) for im in imgs[n]] for n in imgs}
        for pair in zip(rs["alexnet"], rs["vgg16"]):
            for r, n in zip(pair, MODELS):
                assert reg.submit(n, r)
        assert reg.submit("alexnet", rs["alexnet"][2])
        reg.run_until_done()
        reqs[pkg] = rs
    for n in MODELS:
        _, cfg, _, params = fleet[n]
        got = np.stack([r.logits for r in reqs["torch"][n]])
        by_uid = {r.uid: r for r in reqs["torch"][n]}
        for grp in {r.served_group for r in reqs["torch"][n]}:
            x = np.zeros((by_uid[grp[0]].served_bucket, *imgs[n].shape[1:]),
                         np.float32)
            for row, uid in enumerate(grp):
                x[row] = by_uid[uid].image
            want = alexnet.apply(params, cfg, torch.from_numpy(x)).numpy()
            for row, uid in enumerate(grp):
                assert np.array_equal(by_uid[uid].logits, want[row])
        _close(got, np.stack([np.asarray(r.logits)
                              for r in reqs["jax"][n]]))
    s, js = regs["torch"].stats(), regs["jax"].stats()
    assert s["models"]["alexnet"]["images_completed"] == 3
    assert s["models"]["vgg16"]["images_completed"] == 2
    for key in ("images_completed", "images_shed", "images_expired",
                "slots_used", "slot_budget", "accounting_balanced",
                "health"):
        assert s["fleet"][key] == js["fleet"][key], key
    assert s["fleet"]["slots_used"] == 16 and regs["torch"].idle
    for n in MODELS:
        e = regs["torch"][n]
        assert e.sched.submitted == e.sched.completed == len(imgs[n])
        assert e.sched.occupancy == 0
        assert e.bucket_counts == regs["jax"][n].bucket_counts


def test_registry_enforces_slot_budget(fleet):
    _, cfg, _, params = fleet["alexnet"]
    reg = ModelRegistry(slot_budget=20)
    reg.register("a", cfg, CnnServeConfig(max_batch=8), params=params,
                 device="cpu")                      # 16 slots
    with pytest.raises(ValueError, match="slots"):
        reg.register("b", cfg, CnnServeConfig(max_batch=4), params=params,
                     device="cpu")                  # needs 8 > 4 left
    reg.register("c", cfg, CnnServeConfig(max_batch=2), params=params,
                 device="cpu")                      # 4 slots: fits
    assert reg.slots_used == 20
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", cfg, CnnServeConfig(max_batch=1), params=params,
                     device="cpu")
    with pytest.raises(KeyError, match="unknown model"):
        reg.submit("nope", ImageRequest(image=_images(cfg, 1)[0]))


def test_registry_getitem_unknown_model_lists_registered(fleet):
    _, cfg, _, params = fleet["alexnet"]
    reg = ModelRegistry()
    reg.register("alexnet", cfg, CnnServeConfig(max_batch=2), params=params,
                 device="cpu")
    assert "alexnet" in reg and "nope" not in reg
    with pytest.raises(KeyError, match=r"unknown model 'nope'.*alexnet"):
        reg["nope"]
    with pytest.raises(KeyError, match="unknown model"):
        reg.submit("nope", ImageRequest(image=_images(cfg, 1)[0]))


def test_registry_drain_timeout_and_fleet_health(fleet):
    _, cfg, _, params = fleet["alexnet"]
    inj = FaultInjector(0, {"launch.transient": FaultSpec(rate=1.0)})
    reg = ModelRegistry()
    reg.register("sick", cfg,
                 CnnServeConfig(max_batch=2, retry_backoff_ms=0.01,
                                quarantine_threshold=10 ** 6),
                 params=params, faults=inj, device="cpu")
    reg.submit("sick", ImageRequest(image=_images(cfg, 1)[0],
                                    retries=10 ** 6))
    with pytest.raises(DrainTimeout) as ei:
        reg.run_until_done(max_steps=40)
    assert not ei.value.report["sick"]["drained"]
    assert reg.stats()["fleet"]["health"]["sick"] in (HEALTHY, DEGRADED,
                                                      QUARANTINED)


def test_registry_stats_export_and_reset(fleet):
    """Fleet aggregates are the sums of the models' stats; export_state is
    each model's params as numpy; reset_metrics zeroes the counters and
    keeps the packed slabs."""
    reg = ModelRegistry(slot_budget=8)
    for name in MODELS:
        _, cfg, _, params = fleet[name]
        reg.register(name, cfg, CnnServeConfig(max_batch=2), params=params,
                     device="cpu")
    for name in MODELS:
        for im in _images(fleet[name][1], 3, seed=7):
            assert reg.submit(name, ImageRequest(image=im))
    reg.run_until_done()
    s = reg.stats()
    per = s["models"]
    assert s["fleet"]["images_completed"] == 6 == sum(
        p["images_completed"] for p in per.values())
    assert s["fleet"]["imgs_per_s"] == pytest.approx(
        sum(p["imgs_per_s"] for p in per.values()))
    assert s["fleet"]["worst_p99_ms"] == max(
        p["latency_ms"]["p99"] for p in per.values())
    assert s["fleet"]["accounting_balanced"]
    state = reg.export_state()
    assert set(state) == set(MODELS)
    for name in MODELS:
        host = state[name]["params"]
        assert all(isinstance(v, np.ndarray) for sub in host.values()
                   for v in sub.values())
    packed = {n: dict(reg[n]._packed) for n in MODELS}
    reg.reset_metrics()
    s = reg.stats()
    assert s["fleet"]["images_completed"] == 0
    assert all(reg[n]._packed == packed[n] for n in MODELS)


def _chaos_run(pkg, seed, fleet):
    """One seeded chaos run of a two-model fleet (reduced AlexNet as "a",
    reduced VGG-16 as "b") in ``pkg``'s serving stack: (accounting, bucket
    counts, submissions) per model."""
    S = j_serving if pkg == "jax" else t_serving
    clock = S.VirtualClock()
    chaos = {
        "launch.transient": S.FaultSpec(rate=0.25),
        "retire.nonfinite": S.FaultSpec(rate=0.15),
        "stage.corrupt": S.FaultSpec(rate=0.10),
        "launch.crash": S.FaultSpec(rate=0.05, limit=1),
    }
    reg = S.ModelRegistry()
    cfgs = {}
    for name, model in zip("ab", MODELS):
        j_cfg, cfg, np_params, params = fleet[model]
        cfgs[name] = cfg
        kw = (dict(params=np_params) if pkg == "jax"
              else dict(params=params, device="cpu"))
        reg.register(name, j_cfg if pkg == "jax" else cfg,
                     S.CnnServeConfig(max_batch=4, retry_backoff_ms=0.01,
                                      cooldown_ms=0.0),
                     faults=S.FaultInjector(derive_seed(seed, name), chaos),
                     clock=clock, **kw)
    rng = np.random.default_rng(seed)
    counts = {"a": 0, "b": 0}
    for burst in (1, 2, 3, 4, 3, 1, 4, 2):
        model = "a" if rng.uniform() < 0.5 else "b"
        for _ in range(burst):
            dl = 5.0 if rng.uniform() < 0.25 else None
            reg.submit(model, S.ImageRequest(
                image=_images(cfgs[model], 1, seed=counts[model])[0],
                deadline_ms=dl, retries=2))
            counts[model] += 1
        clock.advance(1e-3)
        reg.step()              # interleave serving with arrivals
    for _ in range(5000):
        if reg.idle:
            break
        clock.advance(1e-3)
        reg.step()
    assert reg.idle
    return ({n: reg[n].accounting() for n in "ab"},
            {n: dict(reg[n].bucket_counts) for n in "ab"}, counts)


def test_registry_accounting_property_mixed_chaos(fleet):
    """Property: ``submitted == completed + shed + expired`` on every
    drained engine and fleet-wide under mixed seeded chaos (transient
    launches, NaN retirements, staging corruption, a hard crash) over
    traffic of every group size with a mix of deadlines; the port's counts
    equal the JAX registry's on the same seeded run."""
    buckets_seen = set()
    for seed in range(3):
        acc, buckets, counts = _chaos_run("torch", seed, fleet)
        j_acc, j_buckets, _ = _chaos_run("jax", seed, fleet)
        assert acc == j_acc and buckets == j_buckets, seed
        fleet_sum = {"submitted": 0, "completed": 0, "shed": 0, "expired": 0}
        for name in "ab":
            a = acc[name]
            assert a["balanced"] and a["in_flight"] == 0, (seed, name, a)
            assert a["submitted"] == counts[name]
            assert a["submitted"] == a["completed"] + a["shed"] + a["expired"]
            for k in fleet_sum:
                fleet_sum[k] += a[k]
            buckets_seen |= set(buckets[name])
        assert fleet_sum["submitted"] == sum(counts.values()) == 20
        assert fleet_sum["submitted"] == (fleet_sum["completed"]
                                          + fleet_sum["shed"]
                                          + fleet_sum["expired"])
    assert buckets_seen == {1, 2, 4}


def test_registry_logits_under_chaos_match_the_fault_free_fleet(fleet):
    """Whatever the chaos does, a request that completes carries the
    logits of ``apply`` on its served batch."""
    reg = ModelRegistry()
    clock = VirtualClock()
    chaos = {"launch.transient": FaultSpec(rate=0.3),
             "stage.corrupt": FaultSpec(rate=0.2)}
    for name in MODELS:
        _, cfg, _, params = fleet[name]
        reg.register(name, cfg, CnnServeConfig(max_batch=4,
                                               retry_backoff_ms=0.01,
                                               cooldown_ms=0.0),
                     params=params, faults=FaultInjector(
                         derive_seed(5, name), chaos), clock=clock,
                     device="cpu")
    reqs = {n: [ImageRequest(image=im, retries=6)
                for im in _images(fleet[n][1], 5, seed=9)] for n in MODELS}
    for n in MODELS:
        for r in reqs[n]:
            reg.submit(n, r)
    for _ in range(2000):
        if reg.idle:
            break
        clock.advance(1e-3)
        reg.step()
    assert reg.idle
    for n in MODELS:
        _, cfg, _, params = fleet[n]
        by_uid = {r.uid: r for r in reqs[n]}
        done = [r for r in reqs[n] if r.done]
        assert done and reg[n].accounting()["balanced"]
        for r in done:
            x = np.zeros((r.served_bucket, *r.image.shape), np.float32)
            for row, uid in enumerate(r.served_group):
                x[row] = by_uid[uid].image
            want = alexnet.apply(params, cfg, torch.from_numpy(x)).numpy()
            assert np.array_equal(r.logits, want[r.served_row])
