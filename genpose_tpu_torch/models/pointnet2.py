"""PointNet++ MSG classification encoder (counterpart of ``genpose_tpu/models/pointnet2.py``).

Set-abstraction stage = FPS -> gather -> ball query -> group -> SharedMLP ->
max-pool, channels-last ``[B, N, C]`` throughout.  The geometry of a stage
(FPS centers, ball-query indices, centered grouped coordinates) depends only
on the coordinates, so ``cls_msg_geometry`` computes it once per cloud and
the score and energy encoders both consume it.

Only the ``light`` configuration of the released checkpoints is ported
(reference ``pointnet2.py:57-66``, 1024-d feature).

Precision (JAX ``pointnet2.py:113-160,236-238,405-424``): FPS, the ball
query and the centres always run in float32 (the kernels take float32
only); the centred grouped coordinates are taken in float32 and then cast
to the stage's geometry dtype.  ``encoder_f32_stages`` (``stage_is_f32``)
runs a prefix or a suffix of the stages in float32, the rest in the compute
dtype; ``geometry_dtype`` float32 keeps every stage's grouped coordinates
float32.  Where a stage of one dtype feeds one of another, the grouped
coordinates and features are concatenated in the promoted dtype and cast to
the stage's, as ``jnp.concatenate`` then ``astype`` do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from genpose_tpu_torch.models.layers import SharedMLP
from genpose_tpu_torch.ops.pointcloud import (
    ball_query_msg,
    farthest_point_sample,
    gather_points,
    group_points,
)

CLS_MSG_CONFIGS: Dict[str, Dict[str, Any]] = {
    "light": {  # ClsMSG_CFG_Light (reference pointnet2.py:57-66)
        "NPOINTS": [512, 256, 128, None],
        "RADIUS": [[0.02, 0.04], [0.04, 0.08], [0.08, 0.16], [None, None]],
        "NSAMPLE": [[16, 32], [16, 32], [16, 32], [None, None]],
        "MLPS": [
            [[16, 16, 32], [32, 32, 64]],
            [[64, 64, 128], [64, 96, 128]],
            [[128, 196, 256], [128, 196, 256]],
            [[256, 256, 512], [256, 384, 512]],
        ],
    },
}


def _config(name: str) -> Dict[str, Any]:
    if name not in CLS_MSG_CONFIGS:
        raise NotImplementedError(f"pointnet2_params={name!r} is not ported (only 'light')")
    return CLS_MSG_CONFIGS[name]


def sa_geometry(xyz: torch.Tensor, npoint: Optional[int], radii, nsamples,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Weight-independent geometry of one SA stage.

    Returns ``{"new_xyz", "gidx": [per radius], "grouped_xyz": [per radius]}``
    with ``new_xyz``/``gidx`` None for the GroupAll stage (npoint None).
    ``new_xyz`` is float32; the grouped coordinates are the float32
    differences cast to ``dtype``.
    """
    if npoint is None:
        return {"new_xyz": None, "gidx": [None for _ in radii],
                "grouped_xyz": [xyz.to(dtype)[:, None, :, :] for _ in radii]}
    idx = farthest_point_sample(xyz, npoint)
    new_xyz = gather_points(xyz, idx)  # [B, npoint, 3]
    gidx = list(ball_query_msg(radii, nsamples, xyz, new_xyz))  # every radius, one launch
    grouped_xyz = [(group_points(xyz, gi) - new_xyz[:, :, None, :]).to(dtype) for gi in gidx]
    return {"new_xyz": new_xyz, "gidx": gidx, "grouped_xyz": grouped_xyz}


def stage_is_f32(k: int, n_stages: int, f32_stages: int) -> bool:
    """Whether SA stage ``k`` of ``n_stages`` runs in float32 under
    ``encoder_f32_stages``: the first ``f32_stages`` stages when it is >= 0,
    the last ``|f32_stages|`` when it is negative (``-2`` is the supported
    bfloat16 training mix)."""
    if f32_stages >= 0:
        return k < f32_stages
    return k >= n_stages + f32_stages


def cls_msg_geometry(pointcloud: torch.Tensor, config: str = "light",
                     dtype: torch.dtype = torch.float32, f32_stages: int = 0):
    """Per-stage :func:`sa_geometry` list for :class:`Pointnet2ClsMSG`;
    ``dtype`` and ``f32_stages`` as the consuming encoders'."""
    params = _config(config)
    n_stages = len(params["NPOINTS"])
    xyz = pointcloud[..., :3]
    geoms = []
    for k in range(n_stages):
        sdt = torch.float32 if stage_is_f32(k, n_stages, f32_stages) else dtype
        g = sa_geometry(xyz, params["NPOINTS"][k], params["RADIUS"][k],
                        params["NSAMPLE"][k], dtype=sdt)
        geoms.append(g)
        xyz = g["new_xyz"]  # None after the final GroupAll stage
    return geoms


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (ref ``pointnet2_modules.py:10-93``).

    ``npoint`` None means "group all" (ref ``pointnet2_utils.py:268-291``).
    ``dtype`` is the stage's compute dtype, ``geometry_dtype`` that of its
    inline grouped coordinates (None: ``dtype``).
    """

    def __init__(self, npoint: Optional[int], radii: Sequence, nsamples: Sequence,
                 mlps: Sequence[Sequence[int]], in_channels: int,
                 dtype: torch.dtype = torch.float32,
                 geometry_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.n_scales = len(mlps)
        self.geometry_dtype = dtype if geometry_dtype is None else geometry_dtype
        for i, mlp in enumerate(mlps):  # grouped xyz offsets are concatenated first
            self.add_module(f"mlp_{i}", SharedMLP(in_channels + 3, mlp, dtype=dtype))

    def forward(self, xyz, features, geometry=None):
        """xyz [B, N, 3]; features [B, N, C] or None.  Returns
        (new_xyz [B, npoint, 3] or None, new_features [B, npoint, sum C_out])."""
        if geometry is None:
            geometry = sa_geometry(xyz, self.npoint, self.radii, self.nsamples,
                                   dtype=self.geometry_dtype)
        outs = []
        for i in range(self.n_scales):
            grouped_xyz = geometry["grouped_xyz"][i]
            if features is None:
                g = grouped_xyz
            elif self.npoint is not None:
                g = torch.cat([grouped_xyz, group_points(features, geometry["gidx"][i])], dim=-1)
            else:  # GroupAll: one group holding every point
                g = torch.cat([grouped_xyz, features[:, None]], dim=-1)
            h = getattr(self, f"mlp_{i}")(g)  # its first Dense casts g to the stage dtype
            outs.append(torch.amax(h, dim=2))  # max-pool over the sample axis
        return geometry["new_xyz"], torch.cat(outs, dim=-1)


class Pointnet2ClsMSG(nn.Module):
    """4-stage MSG classification encoder over xyz -> 1024-d global feature
    (ref ``pointnet2.py:166-211``; GenPose feeds no per-point features).
    Stage k computes in float32 where ``stage_is_f32(k, 4, f32_stages)``,
    else in ``dtype``; ``geometry_dtype`` (None: the stage's dtype) sets the
    dtype of every stage's grouped coordinates."""

    def __init__(self, config: str = "light", dtype: torch.dtype = torch.float32,
                 geometry_dtype: Optional[torch.dtype] = None, f32_stages: int = 0):
        super().__init__()
        params = _config(config)
        self.n_stages = len(params["NPOINTS"])
        c = 0
        for k in range(self.n_stages):
            mlps = params["MLPS"][k]
            sdt = torch.float32 if stage_is_f32(k, self.n_stages, f32_stages) else dtype
            self.add_module(f"sa_{k}", PointnetSAModuleMSG(
                npoint=params["NPOINTS"][k], radii=params["RADIUS"][k],
                nsamples=params["NSAMPLE"][k], mlps=mlps, in_channels=c, dtype=sdt,
                geometry_dtype=geometry_dtype))
            c = sum(m[-1] for m in mlps)

    def forward(self, pointcloud: torch.Tensor, geometry=None) -> torch.Tensor:
        """pointcloud [B, N, 3] -> [B, 1024].  ``geometry``: an optional
        precomputed :func:`cls_msg_geometry` list."""
        xyz, features = pointcloud[..., :3], None
        for k in range(self.n_stages):
            xyz, features = getattr(self, f"sa_{k}")(
                xyz, features, geometry=None if geometry is None else geometry[k])
        return features[:, 0, :]
