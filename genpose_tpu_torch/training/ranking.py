"""Ranking loss and energy-based hypothesis sorting (counterpart of ``genpose_tpu/training/ranking.py:23-75``).

- ``ranking_loss``: the reference's O(K^2) pairwise loop (``reward.py:109-128``)
  as one broadcast over an upper-triangular pair mask;
- ``sort_results``: energies in ground-truth-error order, per channel
  (``reward.py:63-83``);
- ``sort_poses_by_energy``: decoupled rot/trans hypothesis sort
  (``reward.py:131-155``);
- ``RewardModel``: the reference's standalone pose-reward MLP
  (``reward.py:14-60``), off every path (the energy net plays its role),
  as in the JAX package.

``jnp.argsort`` is stable, so equal keys keep their index order; every sort
here passes ``stable=True`` (``descending=True`` would order ties
differently, hence the negated keys).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genpose_tpu_torch.models.layers import Dense
from genpose_tpu_torch.ops.pose import get_pose_dim


def ranking_loss(energy: torch.Tensor) -> torch.Tensor:
    """Pairwise sign-based margin over K energies sorted by GT error.

    energy [bs, K, 2], index 1 ordered best to worst.  For each ordered pair
    i < j the term is ``1 + (E_j - E_i) / (|E_i - E_j| + 1e-5)``: ~0 when the
    better pose has the higher energy, ~2 when mis-ranked.  The reference's
    mean over (bs, channels) per pair, then over pairs, is the masked mean
    over every entry.  K < 2 has no pair: the loss is 0, not 0/0.
    """
    K = energy.shape[1]
    if K < 2:
        return energy.new_zeros(())
    e_i = energy[:, :, None, :]  # i (better) axis
    e_j = energy[:, None, :, :]  # j (worse) axis
    diff = 1.0 + (e_j - e_i) / (torch.abs(e_i - e_j) + 1e-5)
    pair_mask = torch.triu(torch.ones(K, K, dtype=torch.bool, device=energy.device), diagonal=1)
    masked = torch.where(pair_mask[None, :, :, None], diff, 0.0)
    n_pairs = K * (K - 1) // 2
    return torch.sum(masked) / (n_pairs * energy.shape[0] * energy.shape[-1])


def sort_results(energy: torch.Tensor, metrics: torch.Tensor) -> torch.Tensor:
    """Gather energies into GT-error order per channel (ref ``reward.py:63-83``).

    energy, metrics [bs, K, 2] (channel 0 rotation, 1 translation)."""
    rot_idx = torch.argsort(metrics[..., 0], dim=1, stable=True)
    trans_idx = torch.argsort(metrics[..., 1], dim=1, stable=True)
    e_rot = torch.gather(energy[..., 0], 1, rot_idx)
    e_trans = torch.gather(energy[..., 1], 1, trans_idx)
    return torch.stack([e_rot, e_trans], dim=-1)


def sort_poses_by_energy(poses: torch.Tensor, energy: torch.Tensor):
    """Rank hypotheses from highest to lowest energy, decoupled rot/trans
    (ref ``reward.py:131-155``).

    poses [bs, K, pose_dim]; energy [bs, K, 2].  Returns (sorted_poses,
    sorted_energy).  Pose rows follow the rotation-energy order; the last 3
    columns (translation) are re-gathered by the translation-energy order.
    """
    order = torch.argsort(-energy, dim=1, stable=True)
    sorted_energy = torch.gather(energy, 1, order)
    rot_order, trans_order = order[..., 0], order[..., 1]
    d = poses.shape[-1]
    sorted_poses = torch.gather(poses, 1, rot_order[..., None].expand(-1, -1, d))
    sorted_trans = torch.gather(poses[..., -3:], 1, trans_order[..., None].expand(-1, -1, 3))
    return torch.cat([sorted_poses[..., :-3], sorted_trans], dim=-1), sorted_energy


class RewardModel(nn.Module):
    """Pose-reward MLP (ref ``reward.py:14-60``): pose encoder pose_dim ->
    256 -> 256, concatenated with the 1024-d cloud feature, decoder
    1280 -> 256 -> 2 (rotation score, translation score).  Layer names are
    flax's auto-names (``Dense_0``..``Dense_3``)."""

    def __init__(self, pose_mode: str = "rot_matrix", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pose_mode, self.pose_dim = pose_mode, get_pose_dim(pose_mode)
        for i, (c, w) in enumerate(((self.pose_dim, 256), (256, 256), (1024 + 256, 256),
                                    (256, 2))):
            self.add_module(f"Dense_{i}", Dense(c, w, dtype=dtype))

    def forward(self, pts_feature: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
        """pts_feature [bs, 1024], pose [bs, pose_dim] -> [bs, 2]."""
        if pose.shape[-1] != self.pose_dim:
            raise ValueError(f"pose dim {pose.shape[-1]} != {self.pose_dim} for "
                             f"{self.pose_mode!r}")
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(pose))))
        f = F.relu(self.Dense_2(torch.cat([pts_feature, h], dim=-1)))
        return self.Dense_3(f)
