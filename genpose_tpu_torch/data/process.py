"""Batch processing: augmentation, pose encoding, zero-centering (counterpart of ``genpose_tpu/data/process.py``).

Reference ``datasets_genpose.py:643-718`` (``process_batch``): the raw numpy
batch a loader hands over goes to the device, is augmented when
``PtsAugConfig`` is given, has its rotation encoded in the pose mode, and is
centered on the mean of its points.

For ``quat_wxyz`` the reference permutes pytorch3d's (w, x, y, z) output by
``[3, 0, 1, 2]`` (``datasets_genpose.py:681``), a latent bug in a path the
released configs do not use; both quaternion modes are encoded correctly
here, as in the JAX package.

A raw batch with RGB crops (``rgb``, uint8 [bs, S, S, 3], and ``pix``, each
point's crop pixel [bs, N, 2], for ``pts_encoder="dinov2_pointnet2"``) has
them copied to the device as they are; the 3D augmentation moves the points
and leaves their pixels.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import PtsAugConfig
from genpose_tpu_torch.data.augment import data_augment
from genpose_tpu_torch.ops.pose import matrix_to_quat_wxyz, matrix_to_rot6d
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.device import resolve_device


def matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """Angles (az, ay, ax) with R = Rz(az) Ry(ay) Rx(ax) (pytorch3d 'ZYX')."""
    ay = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    az = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    ax = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([az, ay, ax], dim=-1)


def encode_rotation(gt_R: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """Rotation matrix [bs, 3, 3] -> the pose mode's rotation vector
    (ref ``datasets_genpose.py:678-692``)."""
    if pose_mode == "quat_wxyz":
        return matrix_to_quat_wxyz(gt_R)
    if pose_mode == "quat_xyzw":
        return matrix_to_quat_wxyz(gt_R)[..., [1, 2, 3, 0]]
    if pose_mode == "euler_xyz":
        return matrix_to_euler_zyx(gt_R)
    if pose_mode == "euler_xyz_sx_cx":
        ang = matrix_to_euler_zyx(gt_R)
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if pose_mode == "rot_matrix":
        return matrix_to_rot6d(gt_R)  # the first two columns of R
    raise NotImplementedError(pose_mode)


def process_batch(batch_sample: Mapping, pose_mode: str = "rot_matrix",
                  generator: Optional[torch.Generator] = None,
                  pts_aug_params: Optional[PtsAugConfig] = None,
                  mini_batch_size: Optional[int] = None, device="cuda",
                  draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Raw batch (numpy arrays or tensors) -> the training batch on ``device``.

    Augments iff ``pts_aug_params`` is given, with draws from ``generator``
    or the given ``draws`` (``data/augment.py::augment_draws``)."""
    dev = resolve_device(device)
    with trace.span("data.process", device=dev):
        batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch_sample.items()
                 if k != "path"}
        if mini_batch_size is not None:
            batch = {k: v[:mini_batch_size] for k, v in batch.items()}
        PC, gt_R, gt_t = batch["pcl_in"], batch["rotation"], batch["translation"]
        if pts_aug_params is not None:
            PC, gt_R, gt_t, _ = data_augment(
                pts_aug_params, PC, gt_R, gt_t, batch["fsnet_scale"], batch["mean_shape"],
                batch["sym_info"], batch["aug_bb"], batch["aug_rt_t"], batch["aug_rt_R"],
                batch["model_point"], batch["nocs_scale"], batch["cat_id"],
                generator=generator, draws=draws)

        gt_pose = torch.cat([encode_rotation(gt_R, pose_mode), gt_t], dim=-1)
        center = torch.mean(PC[:, :, :3], dim=1)
        zero_pts = torch.cat([PC[:, :, :3] - center[:, None, :], PC[:, :, 3:]], dim=-1)
        zero_pose = torch.cat([gt_pose[:, :-3], gt_pose[:, -3:] - center], dim=-1)
        return {
            "pts": PC,
            "pts_color": PC,
            "id": batch["cat_id"].reshape(-1).to(torch.int32),
            "handle_visibility": batch["handle_visibility"].reshape(-1).to(torch.int32),
            "gt_pose": gt_pose,
            "zero_mean_pts": zero_pts,
            "zero_mean_gt_pose": zero_pose,
            "pts_center": center,
            **{k: batch[k] for k in ("rgb", "pix") if k in batch},
        }
