"""GFObjectPose: encoder + score-or-energy head (counterpart of ``genpose_tpu/models/posenet.py``).

The module exposes the methods the agent composes: ``encode_pts`` (cloud ->
1024-d feature), ``precompute_head`` (loop-invariant tail projections of the
feature), ``score_with`` and ``energy_with`` (one head evaluation from those
projections).  ``build_model`` is the entry point that builds one: it resolves the
device, checks the configuration against what the port supports and
initialises the weights from a seed.

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
from torch import nn

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.models.energynet import PoseEnergyNet
from genpose_tpu_torch.models.pointnet2 import Pointnet2ClsMSG
from genpose_tpu_torch.models.scorenet import PoseScoreNet
from genpose_tpu_torch.utils.device import resolve_device
from genpose_tpu_torch.utils.weights import init_params_

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GFObjectPose(nn.Module):
    """Composite model (ref ``posenet.py:18-68``): PointNet++ encoder and a
    score or energy head."""

    def __init__(self, marginal_prob_fn: Callable, pose_mode: str = "rot_matrix",
                 regression_head: str = "Rx_Ry_and_T", posenet_mode: str = "score",
                 pointnet2_params: str = "light", energy_mode: str = "IP",
                 s_theta_mode: str = "score", norm_energy: str = "identical",
                 dtype: torch.dtype = torch.float32, head_dtype: Optional[torch.dtype] = None,
                 geometry_dtype: Optional[torch.dtype] = None, f32_stages: int = 0):
        super().__init__()
        self.posenet_mode = posenet_mode
        # what a precomputed geometry must be built with (``PoseAgent.pts_geometry``)
        self.dtype, self.geometry_dtype, self.f32_stages = dtype, geometry_dtype, f32_stages
        hdt = dtype if head_dtype is None else head_dtype
        self.encoder = Pointnet2ClsMSG(config=pointnet2_params, dtype=dtype,
                                       geometry_dtype=geometry_dtype, f32_stages=f32_stages)
        if posenet_mode == "score":
            self.head = PoseScoreNet(marginal_prob_fn, pose_mode=pose_mode,
                                     regression_head=regression_head, dtype=hdt)
        elif posenet_mode == "energy":
            self.head = PoseEnergyNet(marginal_prob_fn, pose_mode=pose_mode,
                                      regression_head=regression_head,
                                      energy_mode=energy_mode, s_theta_mode=s_theta_mode,
                                      norm_energy=norm_energy, dtype=hdt)
        else:
            raise NotImplementedError(posenet_mode)

    def encode_pts(self, pts: torch.Tensor, geometry=None) -> torch.Tensor:
        """pts [bs, N, 3] -> pts_feat [bs, 1024] (ref ``posenet.py:71-91``).
        ``geometry``: an optional precomputed ``cls_msg_geometry`` list."""
        return self.encoder(pts, geometry=geometry)

    def precompute_head(self, pts_feat: torch.Tensor):
        """Loop-invariant tail projections of pts_feat: computed once per
        sampler call and passed to ``score_with``/``energy_with`` every step."""
        return self.head.precompute(pts_feat)

    def score_with(self, projs, sampled_pose, t):
        if self.posenet_mode != "score":
            raise ValueError("score_with needs a score model")
        return self.head.score_from(projs, sampled_pose, t)

    def energy_with(self, projs, sampled_pose, t, decoupled_rt: bool = True):
        if self.posenet_mode != "energy":
            raise ValueError("energy_with needs an energy model")
        return self.head.energy_from(projs, sampled_pose, t, decoupled_rt=decoupled_rt)


def build_model(cfg: Config, posenet_mode: Optional[str] = None,
                device="cuda") -> GFObjectPose:
    """A ``GFObjectPose`` for ``cfg`` on ``device``, in eval mode, with fresh
    weights drawn from ``cfg.seed``: zero tail outputs, as in the reference
    and the JAX package.  Raises if CUDA is asked for but
    absent, or if ``cfg`` selects something the port does not have yet."""
    dev = resolve_device(device)
    if cfg.pts_encoder != "pointnet2":
        raise NotImplementedError(f"pts_encoder={cfg.pts_encoder!r} is not ported")
    sde = init_sde(cfg.sde_mode)
    model = GFObjectPose(
        marginal_prob_fn=sde.marginal_prob, pose_mode=cfg.pose_mode,
        regression_head=cfg.regression_head, posenet_mode=posenet_mode or cfg.posenet_mode,
        pointnet2_params=cfg.pointnet2_params, energy_mode=cfg.energy_mode,
        s_theta_mode=cfg.s_theta_mode, norm_energy=cfg.norm_energy,
        dtype=DTYPES[cfg.compute_dtype],
        head_dtype=torch.float32 if cfg.head_dtype == "float32" else None,
        geometry_dtype=torch.float32 if cfg.geometry_dtype == "float32" else None,
        f32_stages=cfg.encoder_f32_stages)
    init_params_(model, cfg.seed)
    return model.to(dev).eval().requires_grad_(False)
