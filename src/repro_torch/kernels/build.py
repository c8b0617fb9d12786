"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at first
use into ``build/repro_torch_kernels/<hash of the sources and flags>/`` at
the root of the checkout, so an edited source rebuilds and an unchanged one
is reused.  A failed build raises with the compiler's output.

The conv launchers take one :class:`ConvArgs` (mirror of
``csrc/conv_args.cuh``: the element types of x, bias and output
(``xdt``) and of the slab (``sdt``) among its fields; an armed launch
also sets its slab's rows a tap ``Cs`` and the device address of its
int32 ABFT ``verdict``) by pointer,
raw device pointers (the wrapper's
scratches among them), the rows and columns per thread of the block tile
of their GEMM stage (the direct one's conv stage, the Winograd one's
batched GEMM; the launcher refuses a tile it is not built for), and the
CUDA stream (the Winograd launcher also a host pointer to its transform
matrices and its tile's outputs m);
the BFP matmul, decode-attention, SSD and depthwise-conv launchers take
their pointers (the BFP matmul's, decode attention's and the SSD scan's
f32 scratches, and decode attention's merge tickets, among them), their
extents as ints and the stream (the BFP matmul also its block tile's
columns and x's element type, decode attention q's scale factor and its
cache rows a split, the SSD scan its rows of y a block and state rows a
block, the depthwise conv a host pointer to its transform matrices, its
tile's (m, r), its Winograd tiles a block and its time-reversal flag,
its backward's reduction its f32 partials, r and time steps a block).
Each function returns the ``cudaError_t`` of its launches (0 on success).  A failed build and a
nonzero ``cudaError_t`` both raise :class:`KernelError`, which the serving
engines never retry or degrade around.
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
               "pad_w", "out_h", "out_w", "ncb", "Cb", "nkb", "Kb", "Cs",
               "relu", "lrn_n")
_FLOAT_FIELDS = ("lrn_k", "lrn_alpha", "lrn_beta")
_TAIL_FIELDS = ("pwin", "ps", "ph_out", "pw_out", "PT", "xdt", "sdt")
# element-type codes of ConvArgs.xdt (x, bias and output) and .sdt (slab)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch."""


class ConvArgs(ctypes.Structure):
    """Geometry of one conv launch; field order matches ``ConvArgs`` in
    ``csrc/conv_args.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in _INT_FIELDS]
                + [(n, ctypes.c_float) for n in _FLOAT_FIELDS]
                + [(n, ctypes.c_int) for n in _TAIL_FIELDS]
                + [("verdict", ctypes.c_void_p)])


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
    i = ctypes.c_int
    # (args, x, slab, bias, y, out, rows and columns per thread, stream)
    lib.repro_conv_direct.argtypes = [ctypes.POINTER(ConvArgs), p, p, p, p,
                                      p, i, i, p]
    lib.repro_conv_direct.restype = ctypes.c_int
    # (args, mats, tile outputs m, x, slab, bias, u, m, y, out, rows and
    # columns per thread, stream)
    lib.repro_conv_winograd.argtypes = [ctypes.POINTER(ConvArgs), p, i, p,
                                        p, p, p, p, p, p, i, i, p]
    lib.repro_conv_winograd.restype = ctypes.c_int
    # (x, wq, we, scratch, out, M, K, N, block, columns a block, x's
    # dtype, stream)
    lib.repro_bfp_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.repro_bfp_matmul.restype = ctypes.c_int
    # (q, k, v, lengths, scratch, tickets, out, lse or NULL, D**-0.5 in
    # q's dtype, B, S, H, KV, D, rows a split, dtype, stream)
    lib.repro_decode_attn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_float,
                                      i, i, i, i, i, i, i, p]
    lib.repro_decode_attn.restype = ctypes.c_int
    # (x, dt, A, B, C, y, state, scratch, Bb, L, H, P, G, N, Q, rows of y a
    # block, state rows a block, dtype, stream)
    lib.repro_ssd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                              i, i, p]
    lib.repro_ssd.restype = ctypes.c_int
    # (x, w, bias, mats, out, B, L, C, m, r, tiles a block, reverse,
    # dtype, stream)
    lib.repro_dw1d.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_dw1d.restype = ctypes.c_int
    # (x, dy, partials, dw, db, B, L, C, r, rows a block, dtype, stream)
    lib.repro_dw1d_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.repro_dw1d_wgrad.restype = ctypes.c_int


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
