"""PointNet++ MSG encoders (counterpart of ``genpose_tpu/models/pointnet2.py``).

Set-abstraction stage = FPS -> gather -> ball query -> group -> SharedMLP ->
max-pool, channels-last ``[B, N, C]`` throughout.  The geometry of a stage
(FPS centers, ball-query indices, centered grouped coordinates) depends only
on the coordinates, so ``cls_msg_geometry`` computes it once per cloud and
the score and energy encoders both consume it.

``Pointnet2ClsMSG`` is the classification encoder GenPose uses, in the four
stage configurations of the reference (``pointnet2.py:32-79``): ``full``
and ``lighter`` (5 stages, 4 of them with FPS), ``light`` (the released
checkpoints' default) and ``dense`` (4 stages, 3 with FPS), each ending in a
GroupAll stage and a 1024-d feature.  ``Pointnet2MSG`` is the
segmentation-style SA + FP encoder (reference ``pointnet2.py:92-163``; off
GenPose's paths, as in the JAX package): per-point features from 3-NN
feature propagation (``PointnetFPModule``) and an optional per-point logit.

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

from genpose_tpu_torch.models.layers import Dense, SharedMLP, dropout
from genpose_tpu_torch.ops import sa_stage_cuda
from genpose_tpu_torch.ops.pointcloud import (
    ball_query_msg,
    farthest_point_sample,
    gather_points,
    group_points,
    three_interpolate,
    three_nn,
)
from genpose_tpu_torch.utils import trace

# Segmentation-style config (reference pointnet2.py:18-30).
MSG_CFG: Dict[str, Any] = {
    "NPOINTS": [512, 256, 128, 64],
    "RADIUS": [[0.01, 0.02], [0.02, 0.04], [0.04, 0.08], [0.08, 0.16]],
    "NSAMPLE": [[16, 32], [16, 32], [16, 32], [16, 32]],
    "MLPS": [
        [[16, 16, 32], [32, 32, 64]],
        [[64, 64, 128], [64, 96, 128]],
        [[128, 196, 256], [128, 196, 256]],
        [[256, 256, 512], [256, 384, 512]],
    ],
    "FP_MLPS": [[64, 64], [128, 128], [256, 256], [512, 512]],
    "CLS_FC": [128],
}

# The classification stage configs (reference pointnet2.py:32-79).
CLS_MSG_CONFIGS: Dict[str, Dict[str, Any]] = {
    "full": {  # ClsMSG_CFG (reference pointnet2.py:32-44): 5 stages
        "NPOINTS": [512, 256, 128, 64, None],
        "RADIUS": [[0.01, 0.02], [0.02, 0.04], [0.04, 0.08], [0.08, 0.16],
                   [None, None]],
        "NSAMPLE": [[16, 32], [16, 32], [16, 32], [16, 32], [None, None]],
        "MLPS": [
            [[16, 16, 32], [32, 32, 64]],
            [[64, 64, 128], [64, 96, 128]],
            [[128, 196, 256], [128, 196, 256]],
            [[256, 256, 512], [256, 384, 512]],
            [[512, 512], [512, 512]],
        ],
    },
    "light": {  # ClsMSG_CFG_Light (reference pointnet2.py:57-66), the default
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
    "lighter": {  # ClsMSG_CFG_Lighter
        "NPOINTS": [512, 256, 128, 64, None],
        "RADIUS": [[0.01], [0.02], [0.04], [0.08], [None]],
        "NSAMPLE": [[64], [32], [16], [8], [None]],
        "MLPS": [
            [[32, 32, 64]],
            [[64, 64, 128]],
            [[128, 196, 256]],
            [[256, 256, 512]],
            [[512, 512, 1024]],
        ],
    },
    "dense": {  # ClsMSG_CFG_Dense
        "NPOINTS": [512, 256, 128, None],
        "RADIUS": [[0.02, 0.04], [0.04, 0.08], [0.08, 0.16], [None, None]],
        "NSAMPLE": [[32, 64], [16, 32], [8, 16], [None, None]],
        "MLPS": [
            [[16, 16, 32], [32, 32, 64]],
            [[64, 64, 128], [64, 96, 128]],
            [[128, 196, 256], [128, 196, 256]],
            [[256, 256, 512], [256, 384, 512]],
        ],
    },
}


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
    params = CLS_MSG_CONFIGS[config]
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


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def fused_sa_applies(stage: "PointnetSAModuleMSG", geometry, features) -> bool:
    """Whether a stage's radii take the eval-mode kernel: a grouped stage
    (not GroupAll) whose grouped coordinates and input features are float32
    on the card, whose SharedMLPs compute in float32 with every BatchNorm in
    eval mode, no autograd graph to record, and an instantiation of the
    kernel for each radius' (nsample, input features, widths)."""
    if stage.npoint is None or torch.is_grad_enabled():
        return False
    c = 0
    if features is not None:
        if not _on_card(features) or features.dtype != torch.float32:
            return False
        c = features.shape[-1]
    for i in range(stage.n_scales):
        mlp, g = getattr(stage, f"mlp_{i}"), geometry["grouped_xyz"][i]
        if (not _on_card(g) or g.dtype != torch.float32 or mlp.dtype != torch.float32
                or any(getattr(mlp, f"bn_{j}").training for j in range(mlp.n_layers))
                or not sa_stage_cuda.has_instantiation(stage.nsamples[i], c, mlp)):
            return False
    return True


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
        if fused_sa_applies(self, geometry, features):
            trace.count("sa_stage.fused", self.n_scales)
            return geometry["new_xyz"], self._fused(geometry, features)
        if self.npoint is not None:
            trace.count("sa_stage.plain", self.n_scales)
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

    def _fused(self, geometry, features):
        """Each radius by the kernel into its columns of the stage's output."""
        mlps = [getattr(self, f"mlp_{i}") for i in range(self.n_scales)]
        gidx = [gi.contiguous() for gi in geometry["gidx"]]
        B, M = gidx[0].shape[:2]
        out = torch.empty((B, M, sum(sa_stage_cuda.widths(m)[-1] for m in mlps)),
                          dtype=torch.float32, device=gidx[0].device)
        feats = None if features is None else features.contiguous()
        col = 0
        for i, mlp in enumerate(mlps):
            sa_stage_cuda.sa_stage(mlp, geometry["grouped_xyz"][i].contiguous(), feats, gidx[i],
                                   out, col)
            col += sa_stage_cuda.widths(mlp)[-1]
        return out


class PointnetFPModule(nn.Module):
    """Feature propagation by 3-NN inverse-distance interpolation (ref
    ``pointnet2_modules.py:117-158``): the known points' features
    interpolated onto the unknown points, concatenated with the unknown
    points' own features, then a SharedMLP (flax auto-name ``SharedMLP_0``)."""

    def __init__(self, in_features: int, mlp: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_features, mlp, dtype=dtype)

    def forward(self, unknown, known, unknown_feats, known_feats):
        """unknown [B, n, 3], known [B, m, 3], unknown_feats [B, n, C1] or
        None, known_feats [B, m, C2] -> [B, n, mlp[-1]]."""
        dist, idx = three_nn(unknown, known)
        dist_recip = 1.0 / (dist + 1e-8)
        weight = dist_recip / torch.sum(dist_recip, dim=-1, keepdim=True)
        interpolated = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            interpolated = torch.cat([interpolated, unknown_feats], dim=-1)
        return self.SharedMLP_0(interpolated)


class Pointnet2MSG(nn.Module):
    """Segmentation-style SA + FP encoder (ref ``pointnet2.py:92-163``) over
    ``MSG_CFG``: [B, N, 3] -> per-point features [B, N, 64]; with
    ``cls_head`` also the per-point logit [B, N, 1] (``cls_0`` SharedMLP,
    Dropout(0.5), ``cls_out`` Dense).  The dropout applies in train mode
    when ``forward`` is given a generator (JAX: when the caller supplies a
    dropout rng)."""

    def __init__(self, cls_head: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_head = cls_head
        self.n_stages, self.n_fp = len(MSG_CFG["NPOINTS"]), len(MSG_CFG["FP_MLPS"])
        widths = [0]  # feature channels at each level (none on the input)
        for k in range(self.n_stages):
            mlps = MSG_CFG["MLPS"][k]
            self.add_module(f"sa_{k}", PointnetSAModuleMSG(
                npoint=MSG_CFG["NPOINTS"][k], radii=MSG_CFG["RADIUS"][k],
                nsamples=MSG_CFG["NSAMPLE"][k], mlps=mlps, in_channels=widths[-1],
                dtype=dtype))
            widths.append(sum(m[-1] for m in mlps))
        known = widths[-1]
        for k in reversed(range(self.n_fp)):
            mlp = MSG_CFG["FP_MLPS"][k]
            self.add_module(f"fp_{k}", PointnetFPModule(known + widths[k], mlp, dtype=dtype))
            known = mlp[-1]
        if cls_head:
            c = known
            for j, width in enumerate(MSG_CFG["CLS_FC"]):
                self.add_module(f"cls_{j}", SharedMLP(c, (width,), dtype=dtype))
                c = width
            self.cls_out = Dense(c, 1, dtype=dtype)

    def forward(self, pointcloud: torch.Tensor, generator: Optional[torch.Generator] = None):
        """pointcloud [B, N, 3] -> per-point features, or (features, logit)."""
        l_xyz, l_features = [pointcloud[..., :3]], [None]
        for k in range(self.n_stages):
            new_xyz, feat = getattr(self, f"sa_{k}")(l_xyz[-1], l_features[-1])
            l_xyz.append(new_xyz)
            l_features.append(feat)
        for k in reversed(range(self.n_fp)):  # level k takes level k+1's features
            l_features[k] = getattr(self, f"fp_{k}")(l_xyz[k], l_xyz[k + 1], l_features[k],
                                                     l_features[k + 1])
        per_point = l_features[0]
        if not self.cls_head:
            return per_point
        h = per_point
        for j in range(len(MSG_CFG["CLS_FC"])):
            h = getattr(self, f"cls_{j}")(h)
            if self.training and generator is not None:
                h = dropout(h, 0.5, generator)
        return per_point, self.cls_out(h)


class Pointnet2ClsMSG(nn.Module):
    """MSG classification encoder over xyz -> 1024-d global feature
    (ref ``pointnet2.py:166-211``), in the stage configuration ``config`` of
    ``CLS_MSG_CONFIGS``.  GenPose feeds no per-point features; with
    ``in_features`` C > 0 (GenPose++'s lifted image features) stage 0 groups
    [dxyz ; f_j] of 3 + C channels.  Stage k computes in float32 where
    ``stage_is_f32(k, n_stages, f32_stages)``, else in ``dtype``;
    ``geometry_dtype`` (None: the stage's dtype) sets the dtype of every
    stage's grouped coordinates."""

    def __init__(self, config: str = "light", dtype: torch.dtype = torch.float32,
                 geometry_dtype: Optional[torch.dtype] = None, f32_stages: int = 0,
                 in_features: int = 0):
        super().__init__()
        params = CLS_MSG_CONFIGS[config]
        self.n_stages = len(params["NPOINTS"])
        c = in_features
        for k in range(self.n_stages):
            mlps = params["MLPS"][k]
            sdt = torch.float32 if stage_is_f32(k, self.n_stages, f32_stages) else dtype
            self.add_module(f"sa_{k}", PointnetSAModuleMSG(
                npoint=params["NPOINTS"][k], radii=params["RADIUS"][k],
                nsamples=params["NSAMPLE"][k], mlps=mlps, in_channels=c, dtype=sdt,
                geometry_dtype=geometry_dtype))
            c = sum(m[-1] for m in mlps)

    def forward(self, pointcloud: torch.Tensor, geometry=None,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pointcloud [B, N, 3] -> [B, 1024].  ``geometry``: an optional
        precomputed :func:`cls_msg_geometry` list; ``features``: the points'
        input features [B, N, in_features] (None without them)."""
        xyz = pointcloud[..., :3]
        for k in range(self.n_stages):
            xyz, features = getattr(self, f"sa_{k}")(
                xyz, features, geometry=None if geometry is None else geometry[k])
        return features[:, 0, :]
