"""PointNet++ MSG classification encoder (counterpart of ``genpose_tpu/models/pointnet2.py``).

Set-abstraction stage = FPS -> gather -> ball query -> group -> SharedMLP ->
max-pool, channels-last ``[B, N, C]`` throughout.  The geometry of a stage
(FPS centers, ball-query indices, centered grouped coordinates) depends only
on the coordinates, so ``cls_msg_geometry`` computes it once per cloud and
the score and energy encoders both consume it.

Only the ``light`` configuration of the released checkpoints is ported
(reference ``pointnet2.py:57-66``, 1024-d feature).
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


def sa_geometry(xyz: torch.Tensor, npoint: Optional[int], radii, nsamples) -> Dict[str, Any]:
    """Weight-independent geometry of one SA stage.

    Returns ``{"new_xyz", "gidx": [per radius], "grouped_xyz": [per radius]}``
    with ``new_xyz``/``gidx`` None for the GroupAll stage (npoint None).
    """
    if npoint is None:
        return {"new_xyz": None, "gidx": [None for _ in radii],
                "grouped_xyz": [xyz[:, None, :, :] for _ in radii]}
    idx = farthest_point_sample(xyz, npoint)
    new_xyz = gather_points(xyz, idx)  # [B, npoint, 3]
    gidx = list(ball_query_msg(radii, nsamples, xyz, new_xyz))  # every radius, one launch
    grouped_xyz = [group_points(xyz, gi) - new_xyz[:, :, None, :] for gi in gidx]
    return {"new_xyz": new_xyz, "gidx": gidx, "grouped_xyz": grouped_xyz}


def cls_msg_geometry(pointcloud: torch.Tensor, config: str = "light"):
    """Per-stage :func:`sa_geometry` list for :class:`Pointnet2ClsMSG`."""
    params = _config(config)
    xyz = pointcloud[..., :3]
    geoms = []
    for k in range(len(params["NPOINTS"])):
        g = sa_geometry(xyz, params["NPOINTS"][k], params["RADIUS"][k],
                        params["NSAMPLE"][k])
        geoms.append(g)
        xyz = g["new_xyz"]  # None after the final GroupAll stage
    return geoms


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (ref ``pointnet2_modules.py:10-93``).

    ``npoint`` None means "group all" (ref ``pointnet2_utils.py:268-291``).
    """

    def __init__(self, npoint: Optional[int], radii: Sequence, nsamples: Sequence,
                 mlps: Sequence[Sequence[int]], in_channels: int):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.n_scales = len(mlps)
        for i, mlp in enumerate(mlps):  # grouped xyz offsets are concatenated first
            self.add_module(f"mlp_{i}", SharedMLP(in_channels + 3, mlp))

    def forward(self, xyz, features, geometry=None):
        """xyz [B, N, 3]; features [B, N, C] or None.  Returns
        (new_xyz [B, npoint, 3] or None, new_features [B, npoint, sum C_out])."""
        if geometry is None:
            geometry = sa_geometry(xyz, self.npoint, self.radii, self.nsamples)
        outs = []
        for i in range(self.n_scales):
            grouped_xyz = geometry["grouped_xyz"][i]
            if features is None:
                g = grouped_xyz
            elif self.npoint is not None:
                g = torch.cat([grouped_xyz, group_points(features, geometry["gidx"][i])], dim=-1)
            else:  # GroupAll: one group holding every point
                g = torch.cat([grouped_xyz, features[:, None]], dim=-1)
            h = getattr(self, f"mlp_{i}")(g)
            outs.append(torch.amax(h, dim=2))  # max-pool over the sample axis
        return geometry["new_xyz"], torch.cat(outs, dim=-1)


class Pointnet2ClsMSG(nn.Module):
    """4-stage MSG classification encoder over xyz -> 1024-d global feature
    (ref ``pointnet2.py:166-211``; GenPose feeds no per-point features)."""

    def __init__(self, config: str = "light"):
        super().__init__()
        params = _config(config)
        self.n_stages = len(params["NPOINTS"])
        c = 0
        for k in range(self.n_stages):
            mlps = params["MLPS"][k]
            self.add_module(f"sa_{k}", PointnetSAModuleMSG(
                npoint=params["NPOINTS"][k], radii=params["RADIUS"][k],
                nsamples=params["NSAMPLE"][k], mlps=mlps, in_channels=c))
            c = sum(m[-1] for m in mlps)

    def forward(self, pointcloud: torch.Tensor, geometry=None) -> torch.Tensor:
        """pointcloud [B, N, 3] -> [B, 1024].  ``geometry``: an optional
        precomputed :func:`cls_msg_geometry` list."""
        xyz, features = pointcloud[..., :3], None
        for k in range(self.n_stages):
            xyz, features = getattr(self, f"sa_{k}")(
                xyz, features, geometry=None if geometry is None else geometry[k])
        return features[:, 0, :]
