"""Pose score network (counterpart of ``genpose_tpu/models/scorenet.py``).

MLP conditioned on (pts_feat [1024], pose [pose_dim], t):

- pose encoder pose_dim -> 256 -> 256 (ReLU);
- Gaussian-Fourier t-embedding 128 -> Linear 128 + ReLU;
- fusion tails over ``[pts_feat, t_feat, pose_feat]`` with zero-initialised
  last layers, output divided by sigma(t) + 1e-7 (ref ``scorenet.py:205-217``).

Identical tail shapes fuse into one ``FusedTails`` bank (``Rx_Ry_and_T`` ->
3 x 256); other heads are a list of ``SplitTail``s.

``dtype`` is the head's compute dtype (``head_dtype``): ``t_dense``,
``pose_dense_0/1`` and the tails compute in it; the Fourier features stay
float32.  The score divides by a 2-D ``std`` column, so it is float32 under
any head dtype, as in JAX (a 0-dim float32 divisor would leave a bfloat16
quotient bfloat16 in PyTorch).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from genpose_tpu_torch.models.layers import Dense, FusedTails, GaussianFourierProjection, SplitTail
from genpose_tpu_torch.ops.pose import get_pose_dim


def _tail_specs(regression_head: str, pose_dim: int):
    """(name, hidden, out_dim) per fusion tail (ref ``scorenet.py:118-176``)."""
    if regression_head == "RT":
        return (("tail", 512, pose_dim),)
    if regression_head == "R_and_T":
        return (("tail_rot", 256, pose_dim - 3), ("tail_trans", 256, 3))
    if regression_head == "Rx_Ry_and_T":
        return (("tail_rot_x", 256, 3), ("tail_rot_y", 256, 3), ("tail_trans", 256, 3))
    raise NotImplementedError(regression_head)


class PoseTrunk(nn.Module):
    """Shared (t, pose) conditioning trunk + fusion tails, used by the score
    and energy heads.  ``precompute`` hoists the pts_feat projections out of
    the sampler's step loop."""

    def __init__(self, pose_mode: str = "rot_matrix", regression_head: str = "Rx_Ry_and_T",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        pose_dim = get_pose_dim(pose_mode)
        if regression_head == "Rx_Ry_and_T" and pose_mode != "rot_matrix":
            raise NotImplementedError("Rx_Ry_and_T requires rot_matrix pose mode")
        self.t_fourier = GaussianFourierProjection(embed_dim=128)
        self.t_dense = Dense(128, 128, dtype=dtype)
        self.pose_dense_0 = Dense(pose_dim, 256, dtype=dtype)
        self.pose_dense_1 = Dense(256, 256, dtype=dtype)
        specs = _tail_specs(regression_head, pose_dim)
        if len({(h, o) for _, h, o in specs}) == 1:
            self.tails = FusedTails(num_tails=len(specs), hidden=specs[0][1],
                                    out_dim=specs[0][2], dtype=dtype)
            self.tail_names = None
        else:
            self.tail_names = tuple(name for name, _, _ in specs)
            for name, hidden, out_dim in specs:
                self.add_module(name, SplitTail(hidden, out_dim, dtype=dtype))

    def precompute(self, pts_feat: torch.Tensor):
        """Loop-invariant tail projections of pts_feat (a tensor for the fused
        bank, a tuple for split tails)."""
        if self.tail_names is None:
            return self.tails.precompute(pts_feat)
        return tuple(getattr(self, n).precompute(pts_feat) for n in self.tail_names)

    def f_theta_from(self, projs, sampled_pose: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Head output given precomputed projections.  t is [n, 1], or a
        step-shared [1, 1] that broadcasts through the fused bank."""
        t_feat = F.relu(self.t_dense(self.t_fourier(t[:, 0])))
        pose_feat = F.relu(self.pose_dense_0(sampled_pose))
        pose_feat = F.relu(self.pose_dense_1(pose_feat))
        if self.tail_names is None:
            return self.tails.from_proj(projs, t_feat, pose_feat)
        if t_feat.shape[0] != pose_feat.shape[0]:
            t_feat = t_feat.expand(pose_feat.shape[0], t_feat.shape[1])
        dyn_feat = torch.cat([t_feat, pose_feat], dim=-1)
        return torch.cat([getattr(self, n).from_proj(fp, dyn_feat)
                          for n, fp in zip(self.tail_names, projs)], dim=-1)


class PoseScoreNet(nn.Module):
    def __init__(self, marginal_prob_fn: Callable, pose_mode: str = "rot_matrix",
                 regression_head: str = "Rx_Ry_and_T", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.marginal_prob_fn = marginal_prob_fn
        self.trunk = PoseTrunk(pose_mode=pose_mode, regression_head=regression_head, dtype=dtype)

    def precompute(self, pts_feat):
        return self.trunk.precompute(pts_feat)

    def score_from(self, projs, sampled_pose, t):
        _, std = self.marginal_prob_fn(None, t)
        std = torch.reshape(std, (-1, 1))
        return self.trunk.f_theta_from(projs, sampled_pose, t) / (std + 1e-7)
