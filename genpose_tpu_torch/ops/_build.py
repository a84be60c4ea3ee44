"""Build and load the port's CUDA kernels on first use.

Every ``genpose_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and linked into one shared library with a
plain C interface under ``build/genpose_tpu_torch/``.  The library is loaded
with ``ctypes``; the wrappers (``ops/fps_cuda.py``, ``ops/ball_query_cuda.py``,
``ops/fps_bq_fused_cuda.py``, ``ops/score_head_cuda.py``,
``ops/sa_stage_cuda.py``) pass raw device
pointers and the current CUDA stream as ``c_void_p``.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, and
``-fmad=false``: nvcc otherwise contracts ``a*b + c`` into one FMA, which
rounds once instead of twice and breaks the bit-exact distance compares
against the float32 oracles.  The file name carries a hash of the sources
and flags, and of the headers they include (``csrc/*.cuh``), so an edited
source or header is rebuilt and a stale library never loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "genpose_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgenpose_kernels_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library for these sources is missing.

    Returns the library's path.  Raises ``RuntimeError`` with the compiler's
    output if any ``nvcc`` fails.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(log, end="")
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n{res.stdout}")
        os.replace(tmp_so, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gp_fps.argtypes = [p, p, i, i, i, p]
    lib.gp_fps.restype = i
    lib.gp_ball_query.argtypes = [p, p, i, i, i, i, p, p, p, p]
    lib.gp_ball_query.restype = i
    lib.gp_fps_bq_fused.argtypes = [p, p, p, i, i, i, i, p, p, p]
    lib.gp_fps_bq_fused.restype = i
    lib.gp_score_head.argtypes = [p] * 18 + [i] * 6 + [p]
    lib.gp_score_head.restype = i
    lib.gp_score_head_shape.argtypes = [i, i, i, i, p]
    lib.gp_score_head_shape.restype = i
    lib.gp_sa_stage.argtypes = [p] * 5 + [f, p, p] + [i] * 10 + [p]
    lib.gp_sa_stage.restype = i
    lib.gp_sa_stage_scratch.argtypes = [i] * 5
    lib.gp_sa_stage_scratch.restype = i
    lib.gp_error_string.argtypes = [i]
    lib.gp_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if status != 0:
        msg = library().gp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
