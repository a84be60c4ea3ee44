"""Wrapper of the fused FPS + ball-query CUDA kernel (``csrc/fps_bq_fused.cu``).

Replaces ``genpose_tpu/ops/fps_bq_fused.py::fps_bq_fused``.  The plain
PyTorch version is ``ops/pointcloud.py::fps_bq_fused_ref``; the dispatcher
``ops/pointcloud.py::fps_bq_fused`` calls this wrapper for CUDA tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from genpose_tpu_torch.ops import _build
from genpose_tpu_torch.ops.pointcloud import radius_sq_f32

MAX_POINTS = 8192  # 512 threads x 16 register slots, as csrc/fps.cu
MAX_RADII = 8

# Kernel launches since import.  A run that resets it and reads it afterwards
# shows whether a path went through the kernel.
launches = 0


def fps_bq_fused_cuda(xyz: torch.Tensor, npoint: int, radii: Sequence[float],
                      nsamples: Sequence[int]) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """xyz [B, N, 3] float32 on a CUDA device -> (fps_idx [B, npoint] int32,
    (bq_idx_k [B, npoint, nsamples[k]] int32 for each radius)).

    The ball-query tables are views into one [B, npoint, sum(nsamples)]
    buffer, split by columns."""
    global launches
    if not xyz.is_cuda:
        raise ValueError("fps_bq_fused_cuda takes a CUDA tensor")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be float32 [B, N, 3], got {xyz.dtype} {tuple(xyz.shape)}")
    radii, nsamples = tuple(float(r) for r in radii), tuple(int(s) for s in nsamples)
    if not radii or len(radii) != len(nsamples) or len(radii) > MAX_RADII:
        raise ValueError(f"need 1..{MAX_RADII} radii with one nsample each, got "
                         f"{radii} and {nsamples}")
    if min(nsamples) < 1:
        raise ValueError(f"nsamples must be >= 1, got {nsamples}")
    B, N, _ = xyz.shape
    if not 1 <= N <= MAX_POINTS:
        raise ValueError(f"fps_bq_fused_cuda takes 1..{MAX_POINTS} points, got {N}")
    if npoint < 0:
        raise ValueError(f"npoint must be >= 0, got {npoint}")
    fps_idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    bq = torch.empty((B, npoint, sum(nsamples)), dtype=torch.int32, device=xyz.device)
    if B > 0 and npoint > 0:
        xyz = xyz.contiguous()
        r2 = (ctypes.c_float * len(radii))(*(radius_sq_f32(r) for r in radii))
        ns = (ctypes.c_int * len(nsamples))(*nsamples)
        lib = _build.library()
        with torch.cuda.device(xyz.device):
            stream = torch.cuda.current_stream(xyz.device).cuda_stream
            status = lib.gp_fps_bq_fused(xyz.data_ptr(), fps_idx.data_ptr(), bq.data_ptr(),
                                         B, N, npoint, len(radii), ctypes.addressof(r2),
                                         ctypes.addressof(ns), stream)
            launches += 1
        _build.check(status, "fused FPS + ball query kernel launch")
    return fps_idx, tuple(torch.split(bq, list(nsamples), dim=-1))
