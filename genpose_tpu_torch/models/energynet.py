"""Pose energy network (counterpart of ``genpose_tpu/models/energynet.py``).

Same trunk as the score net; the head output f_theta becomes a scalar or a
decoupled (rot, trans) energy.  The score of an energy model is the gradient
of its energy with respect to the pose, taken with ``torch.autograd.grad``
by the agent (ref ``energynet.py:210-215``).

Modes (defaults from ``configs/config.py:40-42``): energy_mode 'IP' (also
'DAE', 'L2'); s_theta_mode 'score' (also 'decoder', 'identical');
norm_energy 'identical' (also 'std', 'minus').

``dtype`` is the trunk's compute dtype; ``std`` stays a 2-D float32
column, so s_theta and the energies come out as JAX's do (float32 in the
default modes).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from genpose_tpu_torch.models.scorenet import PoseTrunk


class PoseEnergyNet(nn.Module):
    def __init__(self, marginal_prob_fn: Callable, pose_mode: str = "rot_matrix",
                 regression_head: str = "Rx_Ry_and_T", energy_mode: str = "IP",
                 s_theta_mode: str = "score", norm_energy: str = "identical",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.marginal_prob_fn = marginal_prob_fn
        self.energy_mode, self.s_theta_mode, self.norm_energy = (
            energy_mode, s_theta_mode, norm_energy)
        self.trunk = PoseTrunk(pose_mode=pose_mode, regression_head=regression_head, dtype=dtype)

    def precompute(self, pts_feat):
        return self.trunk.precompute(pts_feat)

    def energy_from(self, projs, sampled_pose, t, decoupled_rt: bool = True):
        """Energy [n, 2] if decoupled IP, else [n]."""
        f_theta = self.trunk.f_theta_from(projs, sampled_pose, t)
        _, std = self.marginal_prob_fn(None, t)
        std = torch.reshape(std, (-1, 1))

        # s_theta (ref energynet.py:165-173)
        if self.s_theta_mode == "score":
            s_theta = f_theta / std
        elif self.s_theta_mode == "decoder":
            s_theta = sampled_pose - std * f_theta
        elif self.s_theta_mode == "identical":
            s_theta = f_theta
        else:
            raise NotImplementedError(self.s_theta_mode)

        # energy (ref energynet.py:175-187)
        if self.energy_mode == "DAE":
            energy = -0.5 * torch.sum((sampled_pose - s_theta) ** 2, dim=-1)
        elif self.energy_mode == "L2":
            energy = -0.5 * torch.sum(s_theta ** 2, dim=-1)
        elif self.energy_mode == "IP":
            if decoupled_rt:
                e_rot = torch.sum(sampled_pose[:, :-3] * s_theta[:, :-3], dim=-1)
                e_trans = torch.sum(sampled_pose[:, -3:] * s_theta[:, -3:], dim=-1)
                energy = torch.stack([e_rot, e_trans], dim=-1)
            else:
                energy = torch.sum(sampled_pose * s_theta, dim=-1)
        else:
            raise NotImplementedError(self.energy_mode)

        # normalisation (ref energynet.py:189-197)
        if self.norm_energy == "std":
            denom = std + 1e-7
            energy = energy / (denom[:, 0] if energy.dim() == 1 else denom)
        elif self.norm_energy == "minus":
            energy = -energy
        elif self.norm_energy != "identical":
            raise NotImplementedError(self.norm_energy)
        return energy
