"""Atomic, crc-verified checkpoints (the reference's
``repro/checkpoint/checkpoint.py``), file for file.

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per leaf and a
``manifest.json`` (step; each leaf's name, shape, dtype and file crc32).
A state is a nested dict (or list) of tensors and Python ints; a leaf's
name is its path of keys joined by ``__`` (``params__conv1__w``, ``step``)
and the manifest lists the leaves with dict keys in sorted order, as the
reference's pytree flattening does.  For the same values the files are
byte-identical to the reference's: the same ``.npy`` headers and bytes,
the same manifest.

Writes go to a tmp dir and ``os.replace`` (atomic on POSIX): a killed
writer never corrupts the latest checkpoint.  :func:`restore` verifies
every leaf file's crc32 before it loads: with no step named, a torn or
bit-rotted latest step falls back, with a warning, to the newest step that
verifies; a named step that fails raises :class:`CheckpointCorrupt`.
Manifests without checksums verify by presence only.

bf16: the reference's numpy stores an ml_dtypes bfloat16 array as raw
2-byte records (descr ``<V2``) under manifest dtype ``bfloat16``.  The
port writes the same header and the same 16-bit patterns, moved with
``view`` (no ml_dtypes needed), and reads a 2-byte void array back as
bf16 bits.  (The reference cannot restore these leaves itself: ROADMAP
Queue 3.)

A sharded state (DTensor leaves, ``parallel/sharding.py``) is saved whole:
every rank of its mesh gathers each leaf, rank 0 alone writes, and
:func:`save` returns on every rank once the step is published.  The files
are those of a one-device save of the same values.  :func:`restore` with
``shardings`` places each restored leaf as a DTensor by its
``NamedSharding``.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import warnings
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..nn.module import tree_map_with_path
from ..parallel.collectives import mesh_barrier
from ..parallel.sharding import full, is_dtensor, place

__all__ = ["AsyncCheckpointer", "CheckpointCorrupt", "latest_intact_step",
           "latest_step", "restore", "save", "verify_step"]

# the descr numpy writes for an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"


class CheckpointCorrupt(RuntimeError):
    """An explicitly requested checkpoint step failed integrity checks."""


def _leaf_name(path) -> str:
    return "__".join(str(k) for k in path) or "leaf"


def _flatten(tree, path=()):
    """(path, leaf) pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array its file holds (a bf16 tensor's 16-bit
    patterns as int16) and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(fpath: str, arr: np.ndarray, dtype: str):
    if dtype != "bfloat16":
        np.save(fpath, arr)
        return
    with open(fpath, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _read_leaf(fpath: str) -> torch.Tensor:
    arr = np.load(fpath)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, state, *, keep: int = 3) -> str:
    step = int(state["step"]) if isinstance(state, dict) and \
        "step" in state else 0
    leaves = list(_flatten(state))
    mesh = next((leaf.device_mesh for _, leaf in leaves
                 if is_dtensor(leaf)), None)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if mesh is not None and any(mesh.get_coordinate()):
        for _, leaf in leaves:       # rank 0 gathers and writes
            full(leaf)
        mesh_barrier(mesh)
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for path, leaf in leaves:
        name = _leaf_name(path)
        arr, dtype = _host_array(full(leaf))
        fpath = os.path.join(tmp, name + ".npy")
        _write_leaf(fpath, arr, dtype)
        manifest["leaves"].append({
            "name": name, "shape": list(arr.shape), "dtype": dtype,
            "crc32": _file_crc32(fpath)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic publish
    _gc(ckpt_dir, keep)
    if mesh is not None:
        mesh_barrier(mesh)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def verify_step(ckpt_dir: str, step: int) -> Tuple[bool, List[str]]:
    """Integrity-check one step against its manifest: ``(ok, problems)``.
    A readable manifest, every leaf file present and, where the manifest
    records checksums, every file's crc32 matching."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    problems: List[str] = []
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, [f"manifest unreadable: {e}"]
    for leaf in manifest.get("leaves", []):
        fpath = os.path.join(d, leaf["name"] + ".npy")
        if not os.path.exists(fpath):
            problems.append(f"missing leaf file {leaf['name']}.npy")
            continue
        want = leaf.get("crc32")
        if want is not None and _file_crc32(fpath) != want:
            problems.append(f"crc mismatch on {leaf['name']}.npy")
    return not problems, problems


def latest_intact_step(ckpt_dir: str) -> Optional[int]:
    """Newest step that passes :func:`verify_step`, scanning backward past
    torn or corrupt steps (each skip is warned, never silent)."""
    for step in sorted(_list_steps(ckpt_dir), reverse=True):
        ok, problems = verify_step(ckpt_dir, step)
        if ok:
            return step
        warnings.warn(
            f"checkpoint step {step} under {ckpt_dir} failed integrity "
            f"checks ({'; '.join(problems)}); falling back to the previous "
            f"step", stacklevel=2)
    return None


def restore(ckpt_dir: str, state_like, *, step: Optional[int] = None,
            shardings=None, verify: bool = True):
    """Restore into the structure of ``state_like``: a tensor leaf comes
    back as a tensor of the file's dtype on the device of ``state_like``'s
    leaf, any other leaf as a Python scalar (a 0-d file) or a numpy
    array.  ``shardings``: a tree of ``state_like``'s structure (a subtree
    or leaf may be None or left out) whose ``NamedSharding`` leaves place their
    restored leaves as DTensors on their meshes (an elastic reshard on
    load).

    With ``verify`` (default) the leaf files are checked against the
    manifest's crc32 before any load: with ``step`` None the newest
    *intact* step is restored (a torn latest falls back, with a warning);
    a named corrupt step raises :class:`CheckpointCorrupt`.
    """
    if step is None:
        step = latest_intact_step(ckpt_dir) if verify else latest_step(
            ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no {'intact ' if verify else ''}checkpoints under "
                f"{ckpt_dir}")
    elif verify:
        ok, problems = verify_step(ckpt_dir, step)
        if not ok:
            raise CheckpointCorrupt(
                f"checkpoint step {step} under {ckpt_dir} failed integrity "
                f"checks: {'; '.join(problems)}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")

    def load(path, like):
        t = _read_leaf(os.path.join(d, _leaf_name(path) + ".npy"))
        sharding = _at(shardings, path)
        if sharding is not None:
            return place(t.to(sharding.mesh.device_type), sharding)
        if isinstance(like, torch.Tensor):
            return t.to(like.device)
        return t.item() if t.dim() == 0 else t.numpy()

    return tree_map_with_path(load, state_like)


def _at(tree, path):
    """The subtree of ``tree`` at ``path``; None below a None or an absent
    key."""
    for k in path:
        if tree is None:
            return None
        tree = tree.get(k) if isinstance(tree, dict) else tree[k]
    return tree


def _snapshot(_path, leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Background-thread writer; ``wait()`` drains before exit or
    restore, and re-raises a writer's error."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                save(self.ckpt_dir, item, keep=self.keep)
            except BaseException as e:  # handed to the caller's thread
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, state):
        # snapshot to the host first (a copy even of a CPU tensor), so the
        # caller may go on updating its buffers
        self._q.put(tree_map_with_path(_snapshot, state))
        if self._err:
            raise self._err

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join(timeout=10)
