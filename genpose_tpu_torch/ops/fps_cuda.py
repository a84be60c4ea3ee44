"""Wrapper of the CUDA furthest-point-sampling kernel (``csrc/fps.cu``).

Replaces ``genpose_tpu/ops/fps_pallas.py::fps_pallas``.  The plain PyTorch
version is ``ops/pointcloud.py::farthest_point_sample_ref``; the dispatcher
``ops/pointcloud.py::farthest_point_sample`` calls this wrapper for CUDA
tensors only.
"""

from __future__ import annotations

import torch

from genpose_tpu_torch.ops import _build

MAX_POINTS = 8192  # 1024 threads x 8 register slots (csrc/fps.cu)

# Kernel launches since import.  A run that resets it and reads it afterwards
# shows whether a path went through the kernel.
launches = 0


def fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz [B, N, 3] float32 on a CUDA device -> idx [B, npoint] int32."""
    global launches
    if not xyz.is_cuda:
        raise ValueError("fps_cuda takes a CUDA tensor")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be float32 [B, N, 3], got {xyz.dtype} {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if not 1 <= N <= MAX_POINTS:
        raise ValueError(f"fps_cuda takes 1..{MAX_POINTS} points, got {N}")
    if npoint < 0:
        raise ValueError(f"npoint must be >= 0, got {npoint}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    xyz = xyz.contiguous()
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        status = lib.gp_fps(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
        launches += 1
    _build.check(status, "fps kernel launch")
    return out
