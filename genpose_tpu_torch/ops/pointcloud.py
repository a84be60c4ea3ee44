"""Point-cloud primitives (counterpart of ``genpose_tpu/ops/pointcloud.py``).

Reference semantics (the upstream CUDA extension):

- furthest point sampling, ``src/sampling_gpu.cu:93-208``: seed index 0,
  then ``npoint-1`` rounds of (running min-distance update, argmax with ties
  to the lowest index);
- ball query, ``src/ball_query_gpu.cu:9-45``: for each center the first
  ``nsample`` point indices, in index order, with d^2 < r^2, padded with the
  first hit; an all-zero row when the ball is empty;
- gather / group: plain indexing (``torch.gather``), whose autograd
  backward is the scatter-add of ``group_points_gpu.cu``;
- three-NN interpolation, ``src/interpolate_gpu.cu`` (the segmentation
  encoder's feature propagation): plain PyTorch on every device, as the JAX
  package computes it in plain XLA (no TPU kernel).

Each kernel has two versions.  ``*_ref`` is the plain PyTorch version, a
transcription of the JAX oracle; the dispatchers ``farthest_point_sample``,
``ball_query_msg`` (every radius of a stage in one launch; ``ball_query``
is its one-radius case) and ``fps_bq_fused`` send a CPU tensor there and a
CUDA tensor to the hand-written kernel (``ops/fps_cuda.py``,
``ops/ball_query_cuda.py``, ``ops/fps_bq_fused_cuda.py``), which raises if
it cannot run.  There is no size cutoff and no fallback.  The fused kernel
is off the serving and training paths (``sa_geometry`` runs FPS and one
multi-radius ball query, as the JAX package runs the separate kernels);
``tools/bench_fused_geometry.py`` runs it.

Bit-exactness with the JAX oracles rests on the same float32 operation
order: d^2 = ((dx*dx + dy*dy) + dz*dz), separate multiplies and adds, and
r^2 squared in double precision then rounded once to float32.

Layout: channels-last ``[B, N, C]`` throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((dx^2 + dy^2) + dz^2) over the last axis, broadcasting a against b."""
    d = a - b
    return (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2


def radius_sq_f32(radius: float) -> float:
    """r^2 as the JAX package compares it: squared as a Python double and
    rounded once to float32 (``pointcloud.py:241``).  Never square an f32
    radius: for r=0.1 that lands one ulp above."""
    return float(np.float32(float(radius) * float(radius)))


# ---------------------------------------------------------------------------
# Furthest point sampling
# ---------------------------------------------------------------------------

def farthest_point_sample_ref(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain FPS.  xyz [B, N, 3] float32 -> idx [B, npoint] int32.

    Transcribes ``genpose_tpu/ops/pointcloud.py::farthest_point_sample_ref``:
    running min-distance initialised to 1e10, first index 0, ``torch.argmax``
    keeps the first maximum (so ``npoint > N`` keeps picking index 0 once
    every distance is 0, as ``jnp.argmax`` does).
    """
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = [last]
    for _ in range(npoint - 1):
        d = _sq_dist(xyz, xyz[rows, last][:, None, :])
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1)
        out.append(last)
    return torch.stack(out, dim=1).to(torch.int32)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS: the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if xyz.is_cuda:
        from genpose_tpu_torch.ops.fps_cuda import fps_cuda

        return fps_cuda(xyz, npoint)
    if xyz.device.type != "cpu":
        raise ValueError(f"no FPS for device {xyz.device}")
    return farthest_point_sample_ref(xyz, npoint)


# ---------------------------------------------------------------------------
# Gather / group
# ---------------------------------------------------------------------------

def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M] -> [B, M, C] (ref ``sampling_gpu.cu:8-24``)."""
    index = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M, S] -> [B, M, S, C] (ref ``group_points_gpu.cu:47-86``)."""
    B, M, S = idx.shape
    return gather_points(points, idx.reshape(B, M * S)).reshape(B, M, S, points.shape[-1])


# ---------------------------------------------------------------------------
# Three-NN interpolation (ref ``interpolate_gpu.cu``)
# ---------------------------------------------------------------------------

def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest known points of each unknown point.

    unknown [B, N, 3], known [B, M, 3] -> (dist [B, N, 3], idx [B, N, 3]
    int32), Euclidean distances (the reference wrapper's sqrt of the
    kernel's d^2, ``pointnet2_utils.py:99``).  ``jax.lax.top_k`` orders
    equal distances by the lower index; ``torch.topk`` promises no order on
    ties, so the three smallest are taken by a stable sort, which keeps
    equal distances in index order (duplicate points, as ``sample_points``
    makes by tiling a small cloud, tie exactly)."""
    d2 = _sq_dist(unknown[:, :, None, :], known[:, None, :, :])  # [B, N, M]
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(d2[..., :3], min=0.0)), idx[..., :3].to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted blend (ref ``interpolate_gpu.cu:77-106``).
    features [B, M, C]; idx, weight [B, N, 3] -> [B, N, C]."""
    return torch.sum(group_points(features, idx) * weight[..., None], dim=2)


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------

def ball_query_ref(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor) -> torch.Tensor:
    """Plain ball query.  xyz [B, N, 3] points, new_xyz [B, M, 3] centers ->
    idx [B, M, nsample] int32.

    Transcribes ``genpose_tpu/ops/pointcloud.py::ball_query_ref``: with
    ``ranks = cumsum(mask)`` along N, the index of the (s+1)-th hit is the
    number of positions whose rank is <= s.  Ranks are non-decreasing, so
    that count is ``searchsorted(ranks, s + 1)``, which needs no
    [B, M, S, N] temporary.
    """
    d2 = _sq_dist(new_xyz[:, :, None, :], xyz[:, None, :, :])  # [B, M, N]
    mask = d2 < radius_sq_f32(radius)
    ranks = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)
    cnt = ranks[..., -1:]  # [B, M, 1]
    s_arr = torch.arange(nsample, dtype=torch.int32, device=xyz.device)
    targets = (s_arr + 1).expand(*ranks.shape[:-1], nsample).contiguous()
    sel = torch.searchsorted(ranks, targets).to(torch.int32)  # [B, M, S]
    pad = torch.where(cnt > 0, sel[..., :1], 0)
    return torch.where(s_arr < cnt, sel, pad).to(torch.int32)


def ball_query_msg_ref(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                       new_xyz: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain multi-radius ball query: one :func:`ball_query_ref` per radius.
    Returns (idx_k [B, M, nsamples[k]] int32 for each radius)."""
    if not radii or len(radii) != len(nsamples):
        raise ValueError(f"need one nsample per radius, got {radii} and {nsamples}")
    return tuple(ball_query_ref(r, s, xyz, new_xyz) for r, s in zip(radii, nsamples))


def ball_query_msg(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                   new_xyz: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Ball query at every radius of an MSG stage: one launch of the CUDA
    kernel for CUDA tensors, the plain version on the CPU."""
    if xyz.is_cuda:
        from genpose_tpu_torch.ops.ball_query_cuda import ball_query_cuda

        return ball_query_cuda(radii, nsamples, xyz, new_xyz)
    if xyz.device.type != "cpu":
        raise ValueError(f"no ball query for device {xyz.device}")
    return ball_query_msg_ref(radii, nsamples, xyz, new_xyz)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball query at one radius (:func:`ball_query_msg` with R = 1)."""
    return ball_query_msg((radius,), (nsample,), xyz, new_xyz)[0]


# ---------------------------------------------------------------------------
# Fused FPS + ball query
# ---------------------------------------------------------------------------

def fps_bq_fused_ref(xyz: torch.Tensor, npoint: int, radii: Sequence[float],
                     nsamples: Sequence[int]) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain fused FPS + ball query: FPS -> gather centers -> ball query per
    radius, the contract of ``genpose_tpu/ops/fps_bq_fused.py:28-33``.

    xyz [B, N, 3] float32 -> (fps_idx [B, npoint] int32,
    (bq_idx_k [B, npoint, nsamples[k]] int32 for each radius))."""
    idx = farthest_point_sample_ref(xyz, npoint)
    return idx, ball_query_msg_ref(radii, nsamples, xyz, gather_points(xyz, idx))


def fps_bq_fused(xyz: torch.Tensor, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int]) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Fused FPS + ball query: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if xyz.is_cuda:
        from genpose_tpu_torch.ops.fps_bq_fused_cuda import fps_bq_fused_cuda

        return fps_bq_fused_cuda(xyz, npoint, radii, nsamples)
    if xyz.device.type != "cpu":
        raise ValueError(f"no fused FPS + ball query for device {xyz.device}")
    return fps_bq_fused_ref(xyz, npoint, radii, nsamples)
