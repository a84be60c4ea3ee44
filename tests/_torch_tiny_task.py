"""The JAX convergence suites' tiny task (``tests/_tiny_task.py``: 2
objects, 32 points, bs 16) made with numpy from a seed, for the port's
convergence files: two fixed clouds of ~0.1 m spread with one pose each
(translations ~5 cm); a batch draws an object per row."""

import numpy as np
import torch

from genpose_tpu_torch.ops.pose import get_rot_matrix, rot_diff_degree

N_OBJ, BS, N_PTS = 2, 16, 32


def make_task(seed: int = 0):
    rng = np.random.default_rng(seed)
    base = (rng.normal(size=(N_OBJ, N_PTS, 3)) * 0.1).astype(np.float32)
    gt_pose = rng.normal(size=(N_OBJ, 9)).astype(np.float32)
    gt_pose[:, -3:] *= 0.05
    return base, gt_pose


def make_batch(task, rng):
    """(numpy batch, object index per row) from the numpy ``rng``."""
    base, gt_pose = task
    idx = rng.integers(0, N_OBJ, BS)
    batch = {
        "zero_mean_pts": base[idx],
        "zero_mean_gt_pose": gt_pose[idx],
        "gt_pose": gt_pose[idx],
        "pts_center": np.zeros((BS, 3), np.float32),
        "id": np.zeros((BS,), np.int32),
        "handle_visibility": np.ones((BS,), np.int32),
    }
    return batch, idx


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def errors(pred, gt):
    """(mean rotation error in degrees, mean translation error) of pose
    tensors [bs, 9] against the ground truth."""
    rot = rot_diff_degree(get_rot_matrix(pred[:, :-3], "rot_matrix"),
                          get_rot_matrix(gt[:, :-3], "rot_matrix"))
    return float(rot.mean()), float(torch.linalg.norm(pred[:, -3:] - gt[:, -3:], dim=-1).mean())


def eval_batch(task):
    """The held-out batch of the sampled errors and its ground truth."""
    batch, idx = make_batch(task, np.random.default_rng(999))
    return batch, torch.from_numpy(task[1][idx])
