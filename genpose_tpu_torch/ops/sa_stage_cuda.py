"""Wrapper of the eval-mode grouped set-abstraction kernel (``csrc/sa_stage.cu``).

One radius of a grouped PointNet++ SA stage
(``models/pointnet2.py::PointnetSAModuleMSG``) in eval mode: the neighbour
gather, the [dxyz ; f_j] rows, every Dense -> BatchNorm (running
statistics) -> ReLU layer of the radius' ``SharedMLP`` and the max-pool over
the group's rows, in one launch that writes only the pooled result, straight
into the radius' columns of the stage's concatenated output (a small prep
launch first lays the weights out transposed and the BatchNorm affines in a
scratch buffer).  It replaces no
TPU kernel: the JAX package leaves the SharedMLP to XLA.  The plain version
is ``sa_stage_ref`` (the module's own arithmetic); the module calls this
wrapper when its inputs show the kernel applies, and the plain arithmetic
otherwise (``models/pointnet2.py::fused_sa_applies``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from genpose_tpu_torch.ops import _build

# (nsample, input features, widths) of the kernel's instantiations: the light
# stages 0-2, each radius (csrc/sa_stage.cu's S0R0 .. S2R1).
INSTANTIATIONS = frozenset({
    (16, 0, (16, 16, 32)), (32, 0, (32, 32, 64)),
    (16, 96, (64, 64, 128)), (32, 96, (64, 96, 128)),
    (16, 256, (128, 196, 256)), (32, 256, (128, 196, 256)),
})

# Kernel launches since import.  A run that resets it and reads it afterwards
# shows whether a path went through the kernel.
launches = 0


def widths(mlp) -> tuple:
    """The output widths of a ``SharedMLP``'s layers."""
    return tuple(getattr(mlp, f"dense_{i}").out_features for i in range(mlp.n_layers))


def has_instantiation(nsample: int, in_features: int, mlp) -> bool:
    """Whether the kernel has an instantiation for a radius of ``nsample``
    rows a group, ``in_features`` input features and ``mlp``'s widths."""
    return (nsample, in_features, widths(mlp)) in INSTANTIATIONS


def sa_stage_ref(mlp, grouped_xyz: torch.Tensor, features: Optional[torch.Tensor],
                 gidx: torch.Tensor) -> torch.Tensor:
    """The plain arithmetic of one radius: [dxyz ; f_j] -> ``mlp`` -> the max
    over the group's rows; grouped_xyz [B, M, S, 3], features [B, P, C] or
    None, gidx [B, M, S] -> [B, M, C_out]."""
    from genpose_tpu_torch.ops.pointcloud import group_points

    g = grouped_xyz if features is None else torch.cat(
        [grouped_xyz, group_points(features, gidx)], dim=-1)
    return torch.amax(mlp(g), dim=2)


@functools.cache
def _scratch_floats(nsample: int, in_features: int, ws: tuple) -> int:
    """Floats of the kernel's scratch for a radius: the transposed, padded
    weights and the BatchNorm affines its prep launch writes."""
    return _build.library().gp_sa_stage_scratch(nsample, in_features, *ws)


def _operand(name: str, v: torch.Tensor, dtype, device, vectors: bool = False) -> torch.Tensor:
    if v.device != device or v.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got {v.dtype} on {v.device}")
    if not v.is_contiguous() or (vectors and v.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous" + (" and 16-byte aligned" if vectors else ""))
    return v


def sa_stage(mlp, grouped_xyz: torch.Tensor, features: Optional[torch.Tensor],
             gidx: torch.Tensor, out: torch.Tensor, col0: int) -> torch.Tensor:
    """One radius into ``out[..., col0:col0 + C_out]``: grouped_xyz [B, M, S,
    3], features [B, P, C] (None at stage 0), gidx [B, M, S] int32, out [B,
    M, C_total], all float32 (gidx int32) on one CUDA device; ``mlp`` an
    eval-mode float32 ``SharedMLP`` of three layers over 3 + C inputs.
    Returns ``out``."""
    global launches
    if not grouped_xyz.is_cuda:
        raise ValueError("sa_stage takes CUDA tensors")
    dev = grouped_xyz.device
    if grouped_xyz.dim() != 4 or grouped_xyz.shape[-1] != 3:
        raise ValueError(f"grouped_xyz must be [B, M, S, 3], got {tuple(grouped_xyz.shape)}")
    B, M, S, _ = grouped_xyz.shape
    C = 0 if features is None else features.shape[-1]
    ws = widths(mlp)
    if (S, C, ws) not in INSTANTIATIONS:
        raise ValueError(f"sa_stage has no instantiation for nsample {S}, {C} input features "
                         f"and widths {ws}")
    if mlp.dtype != torch.float32 or any(getattr(mlp, f"bn_{i}").training for i in range(3)):
        raise ValueError("sa_stage takes an eval-mode float32 SharedMLP")
    if tuple(gidx.shape) != (B, M, S):
        raise ValueError(f"gidx must be {(B, M, S)}, got {tuple(gidx.shape)}")
    if out.dim() != 3 or tuple(out.shape[:2]) != (B, M) or out.shape[2] < col0 + ws[-1]:
        raise ValueError(f"out must be [{B}, {M}, >= {col0 + ws[-1]}], got {tuple(out.shape)}")
    _operand("grouped_xyz", grouped_xyz, torch.float32, dev)
    _operand("gidx", gidx, torch.int32, dev)
    _operand("out", out, torch.float32, dev)
    points = 0
    if features is not None:
        if features.dim() != 3 or features.shape[0] != B:
            raise ValueError(f"features must be [{B}, P, C], got {tuple(features.shape)}")
        _operand("features", features, torch.float32, dev, vectors=True)
        points = features.shape[1]
    weights, stats = [], []
    for i in range(mlp.n_layers):
        dense, bn = getattr(mlp, f"dense_{i}"), getattr(mlp, f"bn_{i}")
        weights.append(_operand(f"dense_{i}.weight", dense.weight, torch.float32, dev))
        for name in ("running_mean", "running_var", "weight", "bias"):
            stats.append(_operand(f"bn_{i}.{name}", getattr(bn, name), torch.float32, dev))
    w_ptrs = (ctypes.c_void_p * 3)(*(w.data_ptr() for w in weights))
    bn_ptrs = (ctypes.c_void_p * 12)(*(s.data_ptr() for s in stats))
    lib = _build.library()
    scratch = torch.empty((_scratch_floats(S, C, ws),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.gp_sa_stage(
            grouped_xyz.data_ptr(), None if features is None else features.data_ptr(),
            gidx.data_ptr(), w_ptrs, bn_ptrs, float(mlp.bn_0.eps), scratch.data_ptr(),
            out.data_ptr(), out.shape[2], col0, B * M, M, points, S, C, *ws, stream)
        launches += 1
    _build.check(status, "sa stage kernel launch")
    return out
