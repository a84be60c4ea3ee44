"""Pose error metrics with NOCS symmetry handling (counterpart of ``genpose_tpu/eval/metrics.py``).

- ``pose_errors``: batched rotation / translation errors on tensors, with the
  y-axis symmetry rule (bottle, can, bowl, and a mug whose handle is not
  visible; reference ``metrics.py:103-110``) as a ``torch.where`` over a
  per-class table.  The energy training step ranks candidates by these
  errors on the device, every step.
- ``compute_RT_errors`` / ``get_metrics``: the host-side numpy versions the
  score loop's eval epoch calls (reference ``metrics.py:79-118, 157-187``);
  ``compute_RT_overlaps``: ``compute_RT_errors`` per instance.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from genpose_tpu_torch.ops.pose import get_pose_dim, get_rot_matrix, inverse_RT

_SYM_NAMES = ("bottle", "can", "bowl")


def symmetry_flags(synset_names: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class tables (is_y_symmetric, is_mug), indexed by class id as
    ``synset_names`` is (reference ``metrics.py:104-105``)."""
    sym = np.array([n in _SYM_NAMES for n in synset_names], dtype=bool)
    mug = np.array([n == "mug" for n in synset_names], dtype=bool)
    return sym, mug


def pose_errors(pose_1: torch.Tensor, pose_2: torch.Tensor, class_ids: torch.Tensor,
                handle_visibility: torch.Tensor, synset_names: Sequence[str],
                pose_mode: str = "rot_matrix", o2c_pose: bool = False):
    """(rotation error in degrees [bs], translation error in cm [bs]).

    pose_i [bs, pose_dim]; class_ids, handle_visibility [bs].  The y-axis
    angle for symmetric classes, the geodesic angle otherwise, as
    ``get_metrics`` -> ``compute_RT_errors`` (``metrics.py:79-187``).
    """
    idx = get_pose_dim(pose_mode) - 3
    r1 = get_rot_matrix(pose_1[:, :idx], pose_mode)
    r2 = get_rot_matrix(pose_2[:, :idx], pose_mode)
    t1, t2 = pose_1[:, idx:], pose_2[:, idx:]
    if not o2c_pose:
        r1, t1 = inverse_RT(r1, t1)
        r2, t2 = inverse_RT(r2, t2)

    sym_table, mug_table = symmetry_flags(synset_names)
    dev = pose_1.device
    cid = torch.clamp(class_ids.reshape(-1).long(), 0, len(sym_table) - 1)
    hv = handle_visibility.reshape(-1).long()
    symmetric = (torch.from_numpy(sym_table).to(dev)[cid]
                 | (torch.from_numpy(mug_table).to(dev)[cid] & (hv == 0)))

    y1, y2 = r1[..., :, 1], r2[..., :, 1]  # columns are object axes
    cos_sym = torch.sum(y1 * y2, dim=-1) / torch.clamp(
        torch.linalg.norm(y1, dim=-1) * torch.linalg.norm(y2, dim=-1), min=1e-8)
    rel = torch.matmul(r1, r2.transpose(-1, -2))
    cos_full = (rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2] - 1.0) / 2.0
    cos = torch.where(symmetric, cos_sym, cos_full)
    theta = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    shift = torch.linalg.norm(t1 - t2, dim=-1) * 100.0
    return theta, shift


def compute_RT_errors(RT_1, RT_2, class_id, handle_visibility, synset_names):
    """4x4 sRT error (ref ``metrics.py:79-118``): returns [theta_deg, shift_cm]."""
    if RT_1 is None or RT_2 is None:
        return -1
    if not (np.array_equal(RT_1[3, :], RT_2[3, :])
            and np.array_equal(RT_1[3, :], np.array([0, 0, 0, 1]))):
        raise ValueError("the last rows of the sRT matrices must be [0, 0, 0, 1]")

    R1 = RT_1[:3, :3] / np.cbrt(np.linalg.det(RT_1[:3, :3]))
    T1 = RT_1[:3, 3]
    R2 = RT_2[:3, :3] / np.cbrt(np.linalg.det(RT_2[:3, :3]))
    T2 = RT_2[:3, 3]

    if synset_names[class_id] in ["bottle", "can", "bowl"] or (
        synset_names[class_id] == "mug" and handle_visibility == 0
    ):
        y = np.array([0, 1, 0])
        y1 = R1 @ y
        y2 = R2 @ y
        cos_theta = y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2))
    else:
        R = R1 @ R2.transpose()
        cos_theta = (np.trace(R) - 1) / 2

    theta = np.arccos(np.clip(cos_theta, -1.0, 1.0)) * 180 / np.pi
    shift = np.linalg.norm(T1 - T2) * 100
    return np.array([theta, shift])


def compute_RT_overlaps(class_ids, gt_RT, pred_RT, gt_handle_visibility, synset_names):
    """Per-instance ``compute_RT_errors`` of ``pred_RT[i]`` against
    ``gt_RT[i]``: [num, 2] (deg, cm) (ref ``metrics.py:141-154``)."""
    num = len(class_ids)
    overlaps = np.zeros((num, 2))
    for i in range(num):
        overlaps[i, :] = compute_RT_errors(pred_RT[i], gt_RT[i], int(class_ids[i]),
                                           gt_handle_visibility[i], synset_names)
    return overlaps


def get_metrics(pose_1, pose_2, class_ids, synset_names, gt_handle_visibility,
                pose_mode="rot_matrix", o2c_pose=False):
    """Numpy in, numpy out (reference ``get_metrics``, ``metrics.py:157-187``):
    (rotation error in degrees [bs], translation error in cm [bs]).

    ``o2c_pose=False`` is the reference function's default; the runners pass
    ``cfg.o2c_pose``."""
    as_t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    theta, shift = pose_errors(
        as_t(pose_1).float(), as_t(pose_2).float(),
        as_t(np.asarray(class_ids).reshape(-1)),
        as_t(np.asarray(gt_handle_visibility).reshape(-1)),
        synset_names, pose_mode, o2c_pose)
    return theta.numpy(), shift.numpy()
