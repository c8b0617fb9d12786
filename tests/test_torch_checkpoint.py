"""The port's checkpoints against the JAX package's, on the CPU.

The files must be byte-identical to ``repro.checkpoint.save``'s for the
same values (the ``.npy`` headers and bytes, the manifest with its crc32s),
in f32 and bf16, and each package must restore the other's.  The
reference writes a bf16 leaf as raw 2-byte records (numpy descr ``<V2``)
and cannot load it back (``test_reference_cannot_restore_bf16``); the port
restores it bit for bit.  The rest are the counterparts of
``tests/test_runtime.py``'s checkpoint tests: atomic publish and ``keep``
GC, the crc manifest, the fallback past a torn latest step, and
:class:`AsyncCheckpointer`.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_ranks import one_rank_group  # noqa: E402,F401  (fixture)
from _torch_threads import torch_one_thread  # noqa: E402,F401  (fixture)

from repro import checkpoint as j_ckpt  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_params(seed=0):
    """A small AlexNet-shaped parameter tree (two digits in a layer name,
    so the manifest's sorted order is not the insertion order)."""
    rng = np.random.default_rng(seed)
    shapes = {"conv1": (3, 3, 3, 8), "conv2": (3, 3, 8, 16),
              "conv10": (1, 1, 16, 4), "fc6": (36, 12), "fc7": (12, 5)}
    return {name: {"w": rng.standard_normal(s).astype(np.float32),
                   "b": rng.standard_normal(s[-1]).astype(np.float32)}
            for name, s in shapes.items()}


def _states(np_params, dtype, step=1):
    jdt, tdt = DTYPES[dtype]
    j = {"step": step, "params": {
        layer: {k: jnp.asarray(v).astype(jdt) for k, v in sub.items()}
        for layer, sub in np_params.items()}}
    t = {"step": step, "params": {
        layer: {k: torch.from_numpy(v).to(tdt) for k, v in sub.items()}
        for layer, sub in np_params.items()}}
    return j, t


def _equal(a, b):
    """Bit-equal tensors (bf16 compared by its 16-bit patterns)."""
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


def _bits_equal(got, want):
    return all(_equal(got["params"][layer][k], v)
               for layer, sub in want["params"].items()
               for k, v in sub.items())


@pytest.mark.parametrize("dtype", DTYPES)
def test_files_byte_equal_to_reference(tmp_path, dtype):
    j_state, t_state = _states(_np_params(), dtype)
    a = j_ckpt.save(str(tmp_path / "j"), j_state)
    b = ckpt.save(str(tmp_path / "t"), t_state)
    assert os.path.basename(a) == os.path.basename(b) == "step_0000000001"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) == 12
    with open(os.path.join(b, "manifest.json")) as f:
        manifest = json.load(f)
    assert [leaf["name"] for leaf in manifest["leaves"]][:4] == [
        "params__conv1__b", "params__conv1__w", "params__conv10__b",
        "params__conv10__w"]
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {dtype, "int64"}
    for name in files:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_restores_reference_checkpoint(tmp_path, dtype):
    j_state, t_state = _states(_np_params(1), dtype, step=7)
    j_ckpt.save(str(tmp_path), j_state)
    like = {"step": 0, "params": {
        layer: {k: torch.zeros_like(v) for k, v in sub.items()}
        for layer, sub in t_state["params"].items()}}
    got = ckpt.restore(str(tmp_path), like)
    assert got["step"] == 7 and isinstance(got["step"], int)
    assert _bits_equal(got, t_state)


def test_reference_restores_port_f32_checkpoint(tmp_path):
    j_state, t_state = _states(_np_params(2), "float32", step=3)
    ckpt.save(str(tmp_path), t_state)
    got = j_ckpt.restore(str(tmp_path), j_state)
    assert int(got["step"]) == 3
    for layer, sub in t_state["params"].items():
        for k, v in sub.items():
            np.testing.assert_array_equal(np.asarray(got["params"][layer][k]),
                                          v.numpy())


def test_reference_cannot_restore_bf16(tmp_path):
    """The reference's fault: its bf16 leaves are written as ``<V2``
    records under manifest dtype ``bfloat16``, verify as intact, and fail
    to load (``np.load`` gives ``|V2``, which JAX refuses).  The port
    restores the same files bit-equal."""
    j_state, t_state = _states(_np_params(3), "bfloat16")
    d = str(tmp_path)
    j_ckpt.save(d, j_state)
    assert j_ckpt.verify_step(d, 1) == (True, [])
    raw = np.load(os.path.join(d, "step_0000000001", "params__fc6__w.npy"))
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    with pytest.raises(TypeError, match="V2"):
        j_ckpt.restore(d, j_state)
    assert _bits_equal(ckpt.restore(d, t_state), t_state)


def test_restore_places_leaves_on_the_like_device_and_refuses_shardings(
        tmp_path, one_rank_group):
    """A plain restore lands on the like leaves' device; ``shardings``
    (once refused) places each restored leaf as a DTensor with the
    placements asked for, bits equal, and a save of that sharded state
    writes the plain save's bytes.  The multi-rank case is
    ``tests/test_torch_mesh_train.py``'s."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as sh
    _, t_state = _states(_np_params(), "float32")
    ckpt.save(str(tmp_path / "plain"), t_state)
    got = ckpt.restore(str(tmp_path / "plain"), t_state)
    assert got["params"]["fc6"]["w"].device == torch.device("cpu")
    mesh = make_mesh((1,), ("data",))
    shard = {"params": {name: {"w": sh.NamedSharding(mesh, sh.P("data")),
                               "b": None}
                        for name in t_state["params"]}}
    got = ckpt.restore(str(tmp_path / "plain"), t_state, shardings=shard)
    for name, sub in got["params"].items():
        w = sub["w"]
        assert sh.is_dtensor(w) and not sh.is_dtensor(sub["b"])
        assert w.placements == shard["params"][name]["w"].placements
        assert torch.equal(w.full_tensor(), t_state["params"][name]["w"])
        assert torch.equal(sub["b"], t_state["params"][name]["b"])
    ckpt.save(str(tmp_path / "sharded"), got)
    step = "step_0000000001"
    for f in sorted(os.listdir(tmp_path / "plain" / step)):
        assert (tmp_path / "sharded" / step / f).read_bytes() == \
            (tmp_path / "plain" / step / f).read_bytes(), f


def test_checkpoint_atomic_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    state = {"step": 1, "w": torch.arange(8.0)}
    for s in range(1, 6):
        state["step"] = s
        ckpt.save(d, state, keep=2)
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(d)
                   if p.startswith("step_") and not p.endswith(".tmp"))
    assert steps == [4, 5]
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    restored = ckpt.restore(d, state)
    assert restored["step"] == 5
    assert torch.equal(restored["w"], torch.arange(8.0))


def test_checkpoint_integrity_manifest_and_verify(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, {"step": 1, "w": torch.arange(8.0)})
    ok, problems = ckpt.verify_step(d, 1)
    assert ok and not problems
    leaf = os.path.join(d, "step_0000000001", "w.npy")
    with open(leaf, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    ok, problems = ckpt.verify_step(d, 1)
    assert not ok and any("crc mismatch" in p for p in problems)
    os.remove(leaf)
    ok, problems = ckpt.verify_step(d, 1)
    assert not ok and any("missing leaf" in p for p in problems)


def test_checkpoint_restore_falls_back_past_torn_latest(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2):
        ckpt.save(d, {"step": s, "w": torch.full((4,), float(s))})
    os.remove(os.path.join(d, "step_0000000002", "w.npy"))
    like = {"step": 0, "w": torch.zeros(4)}
    assert ckpt.latest_step(d) == 2
    with pytest.warns(UserWarning, match="failed integrity"):
        assert ckpt.latest_intact_step(d) == 1
    with pytest.warns(UserWarning, match="failed integrity"):
        r = ckpt.restore(d, like)
    assert r["step"] == 1 and torch.equal(r["w"], torch.ones(4))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, like, step=2)
    r = ckpt.restore(d, like, step=1, verify=False)
    assert r["step"] == 1


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    ac = ckpt.AsyncCheckpointer(d, keep=3)
    w = torch.zeros(4)
    for s in (1, 2, 3):
        w.fill_(float(s))
        ac.submit({"step": s, "w": w})
        w.fill_(-1.0)           # after submit: the snapshot is a copy
    ac.close()
    assert ckpt.latest_step(d) == 3
    for s in (1, 2, 3):
        r = ckpt.restore(d, {"step": 0, "w": torch.zeros(4)}, step=s)
        assert torch.equal(r["w"], torch.full((4,), float(s)))


def test_async_checkpointer_writer_error_propagates(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = ckpt.AsyncCheckpointer(str(blocker / "ck"))
    ac.submit({"step": 1, "w": torch.zeros(2)})
    with pytest.raises(OSError):
        ac.wait()
