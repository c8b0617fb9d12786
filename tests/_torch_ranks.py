"""Gloo ranks on the CPU for the port's multi-rank tests.

:func:`run_ranks` runs one Python program in ``world`` subprocesses, one
rank each, that rendezvous through a ``FileStore`` under the test's
``tmp_path`` (no ports, so the suite's xdist workers cannot collide).
Each rank runs torch on one intra-op thread; the program finds its
default process group started (``repro_torch.launch.mesh.
init_process_group("cpu", ...)``), ``RANK`` and ``WORLD`` set, and
``OUT``, a directory to write its results into.  The whole run has a
timeout of its own: a hung rendezvous fails the test fast, every rank
killed.  :func:`one_rank_group` is a fixture: a one-rank gloo group in the
test's own process.
"""
import os
import subprocess
import sys
import textwrap
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """\
import os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.launch.mesh import init_process_group
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["RANKS_OUT"]
init_process_group("cpu", store=dist.FileStore(os.environ["RANKS_STORE"],
                                               WORLD),
                   rank=RANK, world_size=WORLD)
"""

_EPILOGUE = """
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, out_dir, *, timeout: float = 120.0):
    """Run ``code`` on ``world`` gloo ranks; returns each rank's stdout.
    Fails (every rank killed) past ``timeout`` seconds or when a rank
    exits with an error."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "filestore")
    if os.path.exists(store):
        os.remove(store)
    program = _PRELUDE + textwrap.dedent(code) + _EPILOGUE
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
               RANKS_STORE=store, RANKS_OUT=out_dir)
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", program], env=dict(env, RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    assert not hung, (f"ranks {hung} still running after {timeout} s:\n"
                      + _tails(outs))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + _tails(outs)
    return outs


def _tails(outs, n=3000):
    return "\n".join(f"--- rank {r} ---\n{o[-n:]}" for r, o in
                     enumerate(outs))


@pytest.fixture
def one_rank_group():
    """A one-rank gloo default process group in this process (a
    ``HashStore``), destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group
    init_process_group("cpu", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
