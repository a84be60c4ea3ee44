"""The host C helper (counterpart of ``genpose_tpu/native/``): masked
back-projection, the sampling stream and a host FPS in ``preprocess.cpp``,
compiled with ``g++`` on first use and called through ``ctypes``.

A ctypes call releases the GIL while the C code runs, so the thread
loader's workers (``data/loader.py``) back-project and sample in parallel;
``data/dataset_utils.py::backproject_and_sample`` calls
``backproject_sample`` for every training sample and every stage-1 instance.

Build: ``g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off`` into
``build/genpose_tpu_torch/`` beside the CUDA library of ``ops/_build.py``.
The file name carries a hash of the source, the flags and the machine's
architecture, and the library is compiled under a temporary name and
renamed into place, so concurrent first users (test workers, forked loader
processes) all load one whole library.  ``-ffp-contract=off`` keeps each
product and sum rounded on its own: a fused multiply-add in ``gp_fps``'s
squared distance would round otherwise than
``ops/pointcloud.py::farthest_point_sample_ref`` and could pick another
point on a near tie (the CUDA kernels are built with ``-fmad=false`` for
the same reason).  No ``-march=native``: the checkout's ``build/`` may be
copied to a machine with another CPU.

A failed build raises with the compiler's output.  ``GENPOSE_NO_NATIVE``
set to a non-empty value (the JAX package's switch) sends
``backproject_and_sample`` to its plain Python version instead; the
wrappers here never fall back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from genpose_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
DISABLE_ENV = "GENPOSE_NO_NATIVE"

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SEED_MASK = (1 << 64) - 1
_BUILD_LOCK = threading.Lock()  # one build per process; processes race by the rename


def disabled() -> bool:
    """True when the caller set ``GENPOSE_NO_NATIVE``: the data path then
    takes the plain Python stream."""
    return bool(os.environ.get(DISABLE_ENV))


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, platform.machine())).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libgenpose_preprocess_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``preprocess.cpp`` if the library for this source is missing.
    Returns its path; raises ``RuntimeError`` with the compiler's output."""
    out = library_path()
    with _BUILD_LOCK:
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    hint = f"(set {DISABLE_ENV}=1 to use the plain Python stream of data/dataset_utils.py)"
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = Path(tmp) / out.name
        cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp_so)]
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build the host C helper: $ {' '.join(cmd)}: {e} "
                               f"{hint}") from e
        if res.returncode != 0:
            raise RuntimeError(f"the host C helper failed to build {hint}:\n"
                               f"$ {' '.join(cmd)}\n{res.stdout}")
        os.replace(tmp_so, out)  # atomic: a concurrent build never sees half a file


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded helper, built on first call (raises if it cannot be)."""
    lib = ctypes.CDLL(str(build()))
    i64, f32, u64 = ctypes.c_int64, ctypes.c_float, ctypes.c_uint64
    lib.gp_depth_mask_to_pcl.restype = ctypes.c_int
    lib.gp_depth_mask_to_pcl.argtypes = [_F32P, _F32P, _F32P, _F32P, i64,
                                         f32, f32, f32, f32, f32, _F32P]
    lib.gp_sample_points.restype = None
    lib.gp_sample_points.argtypes = [_F32P, i64, i64, u64, _F32P, _I32P]
    lib.gp_backproject_sample.restype = ctypes.c_int
    lib.gp_backproject_sample.argtypes = [_F32P, _F32P, _F32P, _F32P, i64,
                                          f32, f32, f32, f32, f32, i64, u64,
                                          _F32P, _F32P, _I32P]
    lib.gp_fps.restype = None
    lib.gp_fps.argtypes = [_F32P, i64, i64, _I32P, _F32P]
    lib.gp_fps_batch.restype = None
    lib.gp_fps_batch.argtypes = [_F32P, i64, i64, i64, _I32P, _F32P]
    return lib


def _roi(depth, mask, xmap, ymap):
    """The four per-pixel maps as flat float32 arrays of one length."""
    maps = [np.ascontiguousarray(a, dtype=np.float32).ravel() for a in (depth, mask, xmap, ymap)]
    if len({m.size for m in maps}) != 1:
        raise ValueError(f"depth, mask, xmap and ymap sizes differ: {[m.size for m in maps]}")
    return maps


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def depth_mask_to_pcl(depth, mask, xmap, ymap, fx, fy, cx, cy,
                      scale: float = 1.0) -> np.ndarray:
    """Masked back-projection: the (n_valid, 3) float32 camera-frame cloud of
    the pixels with depth > 0 and mask > 0, in pixel order."""
    depth, mask, xmap, ymap = _roi(depth, mask, xmap, ymap)
    out = np.empty((depth.size, 3), dtype=np.float32)
    k = get_lib().gp_depth_mask_to_pcl(
        _fp(depth), _fp(mask), _fp(xmap), _fp(ymap), depth.size,
        float(fx), float(fy), float(cx), float(cy), float(scale), _fp(out))
    return out[:k]


def sample_points(pcl: np.ndarray, n_pts: int, seed: int) -> np.ndarray:
    """Exactly ``n_pts`` points of ``pcl`` (n, 3): the cloud tiled when it is
    short, ``n_pts`` distinct points by the seeded stream when it is long,
    zeros when it is empty."""
    pcl = np.ascontiguousarray(pcl, dtype=np.float32).reshape(-1, 3)
    n = pcl.shape[0]
    out = np.zeros((n_pts, 3), dtype=np.float32)
    scratch = np.empty(max(n, 1), dtype=np.int32)
    get_lib().gp_sample_points(_fp(pcl), n, n_pts, int(seed) & _SEED_MASK, _fp(out),
                               _ip(scratch))
    return out


def backproject_sample(depth, mask, xmap, ymap, fx, fy, cx, cy, scale,
                       n_pts: int, seed: int):
    """Back-projection and sampling in one call: ``(n_valid, (n_pts, 3)
    float32 cloud)``, zeros when no pixel is valid."""
    depth, mask, xmap, ymap = _roi(depth, mask, xmap, ymap)
    n = depth.size
    # zeros: with no valid pixel the C side returns 0 without writing `out`
    out = np.zeros((n_pts, 3), dtype=np.float32)
    buf = np.empty((n, 3), dtype=np.float32)
    scratch = np.empty(max(n, 1), dtype=np.int32)
    k = get_lib().gp_backproject_sample(
        _fp(depth), _fp(mask), _fp(xmap), _fp(ymap), n,
        float(fx), float(fy), float(cx), float(cy), float(scale),
        n_pts, int(seed) & _SEED_MASK, _fp(out), _fp(buf), _ip(scratch))
    return k, out


def fps(pts: np.ndarray, m: int) -> np.ndarray:
    """Host furthest point sampling from index 0: (n, 3) -> (m,) or
    (B, n, 3) -> (B, m) int32, the iteration of
    ``ops/pointcloud.py::farthest_point_sample_ref``."""
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    if pts.ndim not in (2, 3) or pts.shape[-1] != 3:
        raise ValueError(f"fps takes (n, 3) or (B, n, 3) points, got {pts.shape}")
    n = pts.shape[-2]
    dist = np.empty(max(n, 1), dtype=np.float32)
    if pts.ndim == 2:
        out = np.zeros(m, dtype=np.int32)
        get_lib().gp_fps(_fp(pts), n, m, _ip(out), _fp(dist))
        return out
    b = pts.shape[0]
    out = np.zeros((b, m), dtype=np.int32)
    get_lib().gp_fps_batch(_fp(pts), b, n, m, _ip(out), _fp(dist))
    return out
