"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at first
use into ``build/repro_torch_kernels/<hash of the sources and flags>/`` at
the root of the checkout, so an edited source rebuilds and an unchanged one
is reused.  A failed build raises with the compiler's output.

The C interface takes one :class:`ConvArgs` (mirror of ``csrc/conv_args.cuh``)
by pointer, raw device pointers, and the CUDA stream; each function returns
the ``cudaError_t`` of its launch (0 on success).  A failed build and a
nonzero ``cudaError_t`` both raise :class:`KernelError`, which the serving
engine never retries or degrades around.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]
LIB_NAME = "librepro_torch_kernels.so"

_INT_FIELDS = ("B", "H", "W", "Ct", "g", "C", "K", "r", "s", "pad_h",
               "pad_w", "out_h", "out_w", "ncb", "Cb", "nkb", "Kb", "relu",
               "lrn_n")
_FLOAT_FIELDS = ("lrn_k", "lrn_alpha", "lrn_beta")
_TAIL_FIELDS = ("pwin", "ps", "ph_out", "pw_out", "PT")


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch."""


class ConvArgs(ctypes.Structure):
    """Geometry of one conv launch; field order matches ``ConvArgs`` in
    ``csrc/conv_args.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in _INT_FIELDS]
                + [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
                + [(n, ctypes.c_int) for n in _TAIL_FIELDS])


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float        # 0.0 when an existing build was reused
    ptxas_log: str              # nvcc -Xptxas -v output of every source


_LIBRARY: KernelLibrary | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise KernelError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(out_dir / LIB_NAME),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise KernelError(f"nvcc link failed:\n{link.stdout}")
    return "\n".join(log)


def _declare(lib: ctypes.CDLL):
    p = ctypes.c_void_p
    lib.repro_conv_direct.argtypes = [ctypes.POINTER(ConvArgs), p, p, p, p, p]
    lib.repro_conv_direct.restype = ctypes.c_int
    for name in ("repro_conv_winograd", "repro_conv_winograd_fused"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ConvArgs), p, p, p, p, p, p]
        fn.restype = ctypes.c_int


def library() -> KernelLibrary:
    """The loaded kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    seconds = 0.0
    if not so.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
        t0 = time.perf_counter()
        try:
            (tmp / "ptxas.log").write_text(_compile(tmp))
            seconds = time.perf_counter() - t0
            os.replace(tmp, out_dir)
        except OSError:
            if not so.exists():         # not a lost race with another build
                raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _LIBRARY = KernelLibrary(lib=lib, path=so, build_seconds=seconds,
                             ptxas_log=(out_dir / "ptxas.log").read_text())
    return _LIBRARY


def check(err: int, name: str):
    """Raise if a C launcher reported a CUDA error."""
    if err:
        raise KernelError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
