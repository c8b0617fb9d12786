"""Process groups and meshes (the reference's ``repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, one process a device: NCCL on the
card, gloo on the CPU, never the one for the other, or a fake world of
any size for the dry run (:func:`init_fake_world`).  Functions, not
module-level constants: importing this module starts nothing.

:func:`init_process_group` starts the group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) or
from an explicit store: a ``FileStore`` for ranks on one host, a
``HashStore`` for one rank.  NCCL takes one rank a card: two ranks on one
card are refused ("Duplicate GPU detected").
"""
from __future__ import annotations

import math
import os

import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(device_type: str = "cuda", *, store=None,
                       rank: int | None = None,
                       world_size: int | None = None):
    """Start the default process group for ``device_type`` ("cuda": NCCL,
    the rank's card ``LOCAL_RANK`` made current; "cpu": gloo).  ``rank``
    and ``world_size`` default to torchrun's ``RANK`` and ``WORLD_SIZE``;
    without ``store`` the rendezvous is torchrun's ``env://``."""
    import torch.distributed as dist
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: one of "
                         f"{sorted(BACKENDS)}")
    if None in (rank, world_size) and not {"RANK", "WORLD_SIZE"} <= set(
            os.environ):
        raise RuntimeError("init_process_group: no rank and world size "
                           "given and no RANK / WORLD_SIZE set; start the "
                           "ranks with torchrun")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    kw = {"backend": BACKENDS[device_type], "rank": rank,
          "world_size": world_size}
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group('cuda'): "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(**kw)


def init_fake_world(world_size: int, rank: int = 0):
    """Start a fake default process group of ``world_size`` ranks, this
    process being ``rank``: PyTorch's ``fake`` backend, whose collectives
    move nothing (the counterpart of the reference's
    ``--xla_force_host_platform_device_count``).  Meshes of any size then
    build over it with ``device_type="cpu"``, for the dry run's counts on
    meta tensors.  One fake world a process at a time:
    ``torch.distributed.destroy_process_group()`` ends it."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "init_fake_world: this PyTorch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg); the dry run's "
            "mesh cells need it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_mesh(shape, axes, *, device_type: str | None = None):
    """A DeviceMesh of ``shape`` named ``axes`` over ranks 0 .. size - 1 of
    the world (row-major, as ``jax.make_mesh`` lays devices out).  A mesh
    smaller than the world leaves the other ranks out (their
    ``get_coordinate()`` is None): an elastic shrink.  Every rank of the
    world calls it.  ``device_type`` defaults to the group's own: "cuda"
    under NCCL, "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group "
                           "first (or run under torchrun)")
    size, world = math.prod(shape), dist.get_world_size()
    if size > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {size} "
                         f"ranks; the world has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=axes)


def _whole_world(shape, axes, device_type):
    import torch.distributed as dist
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        raise ValueError(f"a {'x'.join(map(str, shape))} {axes} mesh needs "
                         f"a world of {size} ranks; it is {world}")
    return make_mesh(shape, axes, device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _whole_world(shape, axes, device_type)


def make_pipeline_mesh(*, device_type: str | None = None):
    """Multi-pod with the pod axis re-purposed as a pipeline-stage axis
    (inter-pod links carry only microbatch activations per tick)."""
    return _whole_world((2, 16, 16), ("pipe", "data", "model"), device_type)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str | None = None):
    """Small mesh for multi-rank tests (gloo ranks on the CPU)."""
    return _whole_world(tuple(shape), tuple(axes), device_type)
