"""Wrapper of the CUDA ball-query kernel (``csrc/ball_query.cu``).

Replaces ``genpose_tpu/ops/ball_query_pallas.py::ball_query_pallas``.  One
launch serves every radius of an MSG stage.  The plain PyTorch version is
``ops/pointcloud.py::ball_query_msg_ref``; the dispatchers
``ops/pointcloud.py::ball_query_msg`` and ``ball_query`` (one radius) call
this wrapper for CUDA tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from genpose_tpu_torch.ops import _build
from genpose_tpu_torch.ops.pointcloud import radius_sq_f32

MAX_POINTS = 4096  # the cloud is staged in 64 KB of shared memory (csrc/ball_query.cu)
MAX_RADII = 4

# Kernel launches since import.  A run that resets it and reads it afterwards
# shows whether a path went through the kernel.
launches = 0


def ball_query_cuda(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                    new_xyz: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """xyz [B, N, 3], new_xyz [B, M, 3] float32 on one CUDA device ->
    (idx_k [B, M, nsamples[k]] int32 for each radius), in one launch."""
    global launches
    if not (xyz.is_cuda and new_xyz.is_cuda) or xyz.device != new_xyz.device:
        raise ValueError("ball_query_cuda takes CUDA tensors on one device")
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be float32 [B, *, 3], got {t.dtype} {tuple(t.shape)}")
    radii, nsamples = tuple(float(r) for r in radii), tuple(int(s) for s in nsamples)
    if not 1 <= len(radii) <= MAX_RADII or len(radii) != len(nsamples):
        raise ValueError(f"need 1..{MAX_RADII} radii with one nsample each, got "
                         f"{radii} and {nsamples}")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B:
        raise ValueError(f"batch mismatch {B} vs {new_xyz.shape[0]}")
    if not 1 <= N <= MAX_POINTS:
        raise ValueError(f"ball_query_cuda takes 1..{MAX_POINTS} points, got {N}")
    if B > 65535 or min(nsamples) < 0:
        raise ValueError(f"bad batch {B} or nsamples {nsamples}")
    outs = tuple(torch.empty((B, M, s), dtype=torch.int32, device=xyz.device)
                 for s in nsamples)
    if B == 0 or M == 0 or max(nsamples) == 0:
        return outs
    xyz, new_xyz = xyz.contiguous(), new_xyz.contiguous()
    R = len(radii)
    r2 = (ctypes.c_float * R)(*(radius_sq_f32(r) for r in radii))
    ns = (ctypes.c_int * R)(*nsamples)
    ptrs = (ctypes.c_void_p * R)(*(t.data_ptr() for t in outs))
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        status = lib.gp_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, R,
                                   ctypes.addressof(r2), ctypes.addressof(ns),
                                   ctypes.addressof(ptrs), stream)
        launches += 1
    _build.check(status, "ball query kernel launch")
    return outs
