"""GFObjectPose: encoder + score-or-energy head (counterpart of ``genpose_tpu/models/posenet.py``).

The encoder is ``pts_encoder``'s: PointNet (``pointnet``), PointNet++
(``pointnet2``, in the stage configuration ``pointnet2_params``), or both
with their features concatenated and fused by a Dense(1024) + ReLU
(``pointnet_and_pointnet2``; ref ``posenet.py:71-91``), or GenPose++'s
``dinov2_pointnet2``: the frozen DINOv2 ViT-S/14 ``image_tower``
(``models/vit.py``) over the object's RGB crop, whose patch features,
lifted to the points, enter PointNet++ stage 0 as 384 per-point input
channels (the port's only encoder with no JAX counterpart).  The module
exposes the methods the agent composes: ``encode_pts`` (cloud, and the
lifted features under ``dinov2_pointnet2`` -> 1024-d feature),
``precompute_head`` (loop-invariant tail projections of the feature),
``score_with``, ``energy_with`` and ``denoise_with`` (one head evaluation
from those projections).  A score model under ``sde_mode="edm"`` has the
EDM decoder head (``PoseDecoderNet``, JAX ``agent.py:72,89``): its
``score_with`` is the denoiser's implied score, ``denoise_with`` the
denoiser.  ``build_model`` is the entry point that builds one: it resolves
the device and initialises the weights from a seed.

Precision knobs (JAX ``config.py:119-177``, ``posenet.py:49-125``):
``compute_dtype`` sets the encoder's and, with ``head_dtype="compute"``,
the heads' compute dtype (``head_dtype="float32"`` keeps the heads
float32); ``geometry_dtype="float32"`` keeps the grouped coordinates
float32; ``encoder_f32_stages`` runs a prefix (>= 0) or suffix (< 0) of the
SA stages in float32.  ``bn_dtype`` is accepted and changes nothing: the
SharedMLPs' BatchNorm always normalises in float32, which is what the JAX
package's both settings compute (``tests/test_precision_knobs.py``).
Parameters, BatchNorm statistics and the Fourier ``W`` are float32 always.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.models.energynet import PoseEnergyNet
from genpose_tpu_torch.models.layers import Dense
from genpose_tpu_torch.models.pointnet import PointNetfeat
from genpose_tpu_torch.models.pointnet2 import Pointnet2ClsMSG
from genpose_tpu_torch.models.scorenet import PoseDecoderNet, PoseScoreNet
from genpose_tpu_torch.models.vit import WIDTH, ImageTower
from genpose_tpu_torch.utils.device import resolve_device
from genpose_tpu_torch.utils.weights import init_params_

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GFObjectPose(nn.Module):
    """Composite model (ref ``posenet.py:18-68``): the ``pts_encoder``
    encoder and a score, EDM decoder (``decoder_head``) or energy head.
    Module names follow the flax tree: ``encoder``, or ``encoder_pn``,
    ``encoder_pn2`` and ``fusion_layer``; then ``head``.  Under
    ``dinov2_pointnet2`` the frozen ``image_tower`` comes first."""

    def __init__(self, marginal_prob_fn: Callable, pose_mode: str = "rot_matrix",
                 regression_head: str = "Rx_Ry_and_T", posenet_mode: str = "score",
                 pts_encoder: str = "pointnet2", pointnet2_params: str = "light",
                 energy_mode: str = "IP", s_theta_mode: str = "score",
                 norm_energy: str = "identical", dtype: torch.dtype = torch.float32,
                 head_dtype: Optional[torch.dtype] = None,
                 geometry_dtype: Optional[torch.dtype] = None, f32_stages: int = 0,
                 decoder_head: bool = False):
        super().__init__()
        self.posenet_mode, self.decoder_head = posenet_mode, decoder_head
        self.pts_encoder = pts_encoder
        # what a precomputed geometry must be built with (``PoseAgent.pts_geometry``)
        self.dtype, self.geometry_dtype, self.f32_stages = dtype, geometry_dtype, f32_stages
        hdt = dtype if head_dtype is None else head_dtype

        def pointnet2(in_features: int = 0):
            return Pointnet2ClsMSG(config=pointnet2_params, dtype=dtype,
                                   geometry_dtype=geometry_dtype, f32_stages=f32_stages,
                                   in_features=in_features)

        if pts_encoder == "pointnet":
            self.encoder = PointNetfeat(in_dim=3, out_dim=1024, dtype=dtype)
        elif pts_encoder == "pointnet2":
            self.encoder = pointnet2()
        elif pts_encoder == "pointnet_and_pointnet2":
            self.encoder_pn = PointNetfeat(in_dim=3, out_dim=1024, dtype=dtype)
            self.encoder_pn2 = pointnet2()
            self.fusion_layer = Dense(2048, 1024, dtype=dtype)
        elif pts_encoder == "dinov2_pointnet2":
            self.image_tower = ImageTower()
            self.encoder = pointnet2(in_features=WIDTH)
        else:
            raise NotImplementedError(pts_encoder)
        if posenet_mode == "score" and decoder_head:
            self.head = PoseDecoderNet(marginal_prob_fn, pose_mode=pose_mode,
                                       regression_head=regression_head, dtype=hdt)
        elif posenet_mode == "score":
            self.head = PoseScoreNet(marginal_prob_fn, pose_mode=pose_mode,
                                     regression_head=regression_head, dtype=hdt)
        elif posenet_mode == "energy":
            self.head = PoseEnergyNet(marginal_prob_fn, pose_mode=pose_mode,
                                      regression_head=regression_head,
                                      energy_mode=energy_mode, s_theta_mode=s_theta_mode,
                                      norm_energy=norm_energy, dtype=hdt)
        else:
            raise NotImplementedError(posenet_mode)

    def encode_pts(self, pts: torch.Tensor, geometry=None,
                   features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pts [bs, N, 3] -> pts_feat [bs, 1024] (ref ``posenet.py:71-91``).
        ``geometry``: an optional precomputed ``cls_msg_geometry`` list for
        the PointNet++ stages (the plain PointNet encoder takes none);
        ``features``: the lifted image features [bs, N, 384] that
        ``dinov2_pointnet2`` needs and no other encoder takes."""
        if (features is not None) != (self.pts_encoder == "dinov2_pointnet2"):
            raise ValueError(f"the {self.pts_encoder} encoder takes "
                             f"{'lifted' if features is None else 'no'} image features")
        if self.pts_encoder == "pointnet":
            return self.encoder(pts)
        if self.pts_encoder == "pointnet2":
            return self.encoder(pts, geometry=geometry)
        if self.pts_encoder == "dinov2_pointnet2":
            return self.encoder(pts, geometry=geometry, features=features)
        feat = torch.cat([self.encoder_pn(pts), self.encoder_pn2(pts, geometry=geometry)], dim=-1)
        return F.relu(self.fusion_layer(feat))

    def precompute_head(self, pts_feat: torch.Tensor):
        """Loop-invariant tail projections of pts_feat: computed once per
        sampler call and passed to ``score_with``/``energy_with`` every step."""
        return self.head.precompute(pts_feat)

    def score_with(self, projs, sampled_pose, t):
        if self.posenet_mode != "score":
            raise ValueError("score_with needs a score model")
        return self.head.score_from(projs, sampled_pose, t)

    def denoise_with(self, projs, sampled_pose, t):
        if not self.decoder_head:
            raise ValueError("denoise_with needs the EDM decoder head")
        return self.head.denoise_from(projs, sampled_pose, t)

    def energy_with(self, projs, sampled_pose, t, decoupled_rt: bool = True):
        if self.posenet_mode != "energy":
            raise ValueError("energy_with needs an energy model")
        return self.head.energy_from(projs, sampled_pose, t, decoupled_rt=decoupled_rt)


def build_model(cfg: Config, posenet_mode: Optional[str] = None,
                device="cuda") -> GFObjectPose:
    """A ``GFObjectPose`` for ``cfg`` on ``device``, in eval mode, with fresh
    weights drawn from ``cfg.seed``: zero tail outputs, as in the reference
    and the JAX package (the image tower's: ``ImageTower.reset_``).  A score
    model under ``sde_mode="edm"`` gets the EDM decoder head.  Raises if
    CUDA is asked for but absent, or for a value of ``pts_encoder``,
    ``pointnet2_params``, ``pose_mode`` or ``regression_head`` that neither
    package takes (``dinov2_pointnet2`` is the port's alone)."""
    dev = resolve_device(device)
    sde = init_sde(cfg.sde_mode)
    mode = posenet_mode or cfg.posenet_mode
    model = GFObjectPose(
        marginal_prob_fn=sde.marginal_prob, pose_mode=cfg.pose_mode,
        regression_head=cfg.regression_head, posenet_mode=mode,
        pts_encoder=cfg.pts_encoder, pointnet2_params=cfg.pointnet2_params,
        energy_mode=cfg.energy_mode,
        s_theta_mode=cfg.s_theta_mode, norm_energy=cfg.norm_energy,
        dtype=DTYPES[cfg.compute_dtype],
        head_dtype=torch.float32 if cfg.head_dtype == "float32" else None,
        geometry_dtype=torch.float32 if cfg.geometry_dtype == "float32" else None,
        f32_stages=cfg.encoder_f32_stages, decoder_head=cfg.sde_mode == "edm" and mode == "score")
    init_params_(model, cfg.seed)
    return model.to(dev).eval().requires_grad_(False)
