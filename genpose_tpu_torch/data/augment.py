"""Batched 3D point-cloud augmentations, FS-Net style (counterpart of ``genpose_tpu/data/augment.py``).

Reference ``utils/data_augmentation.py:71-305``: every augmentation is
computed for the whole batch and kept per sample where a Bernoulli flag
says so (``torch.where``).  Probabilities come from ``PtsAugConfig``
(reference ``config.py:97-104``):

- bbox anisotropic scaling (symmetric classes share the x/z factor);
- random rigid rotation + translation (the loader's ``aug_rt_*`` draws);
- box-cage y-deformation for bowl (id 1) and mug (id 5);
- per-point jitter toward or away from the object center.

``get_rotation`` builds one rotation from Euler angles in degrees.

The random numbers of one call are drawn together by ``augment_draws`` from
a ``torch.Generator``, or passed in, so tests can give the JAX package's
draws to both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from genpose_tpu_torch.config import PtsAugConfig
from genpose_tpu_torch.parallel import group as parallel


def get_rotation(x_deg, y_deg, z_deg) -> torch.Tensor:
    """Rz @ Ry @ Rx in float32 from angles in degrees (ref
    ``data_augmentation.py:197-213``; ``data/nocs.py::get_rotation_np`` is
    the loader's numpy one)."""
    x, y, z = (torch.deg2rad(torch.as_tensor(v, dtype=torch.float32))
               for v in (x_deg, y_deg, z_deg))
    cx, sx, cy, sy, cz, sz = torch.cos(x), torch.sin(x), torch.cos(y), torch.sin(y), \
        torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    return rz @ ry @ rx


def _to_object(R, t, pc):
    """R^T (pc - t): points in the object frame."""
    return torch.einsum("bij,bnj->bni", R.transpose(-1, -2), pc - t[:, None, :])


def _to_camera(R, t, pc):
    return torch.einsum("bij,bnj->bni", R, pc) + t[:, None, :]


def defor_3D_bb_in_batch(pc, model_point, R, t, s, sym, aug_bb):
    """Anisotropic bbox scaling in the object frame (ref ``data_augmentation.py:71-80``)."""
    pc_reproj = _to_object(R, t, pc)
    sym_aug_bb = (aug_bb + aug_bb[:, [2, 1, 0]]) / 2.0
    new_aug_bb = torch.where(sym[:, 0:1] == 1, sym_aug_bb, aug_bb)
    pc_new = _to_camera(R, t, pc_reproj * new_aug_bb[:, None, :])
    return pc_new, s * new_aug_bb, model_point * new_aug_bb[:, None, :]


def defor_3D_rt_in_batch(pc, R, t, aug_rt_t, aug_rt_r):
    """Random rigid perturbation (ref ``data_augmentation.py:187-194``)."""
    pc_new = torch.einsum("bij,bnj->bni", aug_rt_r, pc + aug_rt_t[:, None, :])
    R_new = torch.matmul(aug_rt_r, R)
    t_new = torch.einsum("bij,bj->bi", aug_rt_r, t + aug_rt_t)
    return pc_new, R_new, t_new


def defor_3D_bc_in_batch(pc, R, t, s, model_point, nocs_scale, ey_up, ey_down):
    """Box-cage deformation along y (ref ``data_augmentation.py:109-129``);
    ey_up, ey_down [bs, 1] in [0.8, 1.2)."""
    pc_reproj = _to_object(R, t, pc)
    s_y = s[..., 1:2]
    resize = (pc_reproj[..., 1] + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down
    pc_reproj = torch.stack([pc_reproj[..., 0] * resize, pc_reproj[..., 1],
                             pc_reproj[..., 2] * resize], dim=-1)
    pc_new = _to_camera(R, t, pc_reproj)
    mp_resize = (model_point[..., 1] + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down
    mp = torch.stack([model_point[..., 0] * mp_resize, model_point[..., 1],
                      model_point[..., 2] * mp_resize], dim=-1)
    s_new = (torch.amax(mp, dim=1) - torch.amin(mp, dim=1)) * nocs_scale[:, None]
    return pc_new, s_new


def defor_3D_pc(pc, gt_t, r: float, jitter):
    """Per-point jitter relative to the object center (ref
    ``data_augmentation.py:136-143``); jitter [bs, N, 3] in [0, 1)."""
    return pc + jitter * r * (pc - gt_t[:, None, :])


def augment_draws(bs: int, n_pts: int, generator: Optional[torch.Generator] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """The random numbers of one ``data_augment`` call: the four flags'
    uniforms [bs, 1], the box-cage factors [bs, 1] in [0.8, 1.2) and the
    per-point jitter [bs, N, 3] in [0, 1)."""
    if generator is not None:
        device = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"bb": u(bs, 1), "rt": u(bs, 1), "bc": u(bs, 1), "pc": u(bs, 1),
            "ey_up": u(bs, 1) * 0.4 + 0.8, "ey_down": u(bs, 1) * 0.4 + 0.8,
            "jitter": u(bs, n_pts, 3)}


def data_augment(params: PtsAugConfig, PC, gt_R, gt_t, gt_s, mean_shape, sym, aug_bb,
                 aug_rt_t, aug_rt_r, model_point, nocs_scale, obj_ids,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flag-gated batched augmentation (ref ``data_augmentation.py:234-305``).

    Returns (PC, gt_R, gt_t, gt_s).  ``draws`` as ``augment_draws`` makes
    them, else drawn from ``generator``."""
    bs = PC.shape[0]
    if draws is None:
        draws = parallel.local_draw(
            lambda n: augment_draws(n, PC.shape[1], generator, PC.device), bs)

    # bbox scaling
    flag = draws["bb"] < params.aug_bb_pro
    PC_new, s_new, mp_new = defor_3D_bb_in_batch(
        PC, model_point, gt_R, gt_t, gt_s + mean_shape, sym, aug_bb)
    PC = torch.where(flag[..., None], PC_new, PC)
    gt_s = torch.where(flag, s_new - mean_shape, gt_s)
    model_point = torch.where(flag[..., None], mp_new, model_point)

    # rigid perturbation
    flag = draws["rt"] < params.aug_rt_pro
    PC_new, R_new, t_new = defor_3D_rt_in_batch(PC, gt_R, gt_t, aug_rt_t, aug_rt_r)
    PC = torch.where(flag[..., None], PC_new, PC)
    gt_R = torch.where(flag[..., None], R_new, gt_R)
    gt_t = torch.where(flag, t_new, gt_t)

    # box-cage (bowl id 1, mug id 5 with 0-indexed cat ids; ref data_augmentation.py:292)
    obj = obj_ids.reshape(bs)
    flag = (draws["bc"] < params.aug_bc_pro) & ((obj == 5) | (obj == 1))[:, None]
    PC_new, s_new = defor_3D_bc_in_batch(PC, gt_R, gt_t, gt_s + mean_shape, model_point,
                                         nocs_scale, draws["ey_up"], draws["ey_down"])
    PC = torch.where(flag[..., None], PC_new, PC)
    gt_s = torch.where(flag, s_new - mean_shape, gt_s)

    # per-point jitter
    flag = draws["pc"] < params.aug_pc_pro
    PC = torch.where(flag[..., None], defor_3D_pc(PC, gt_t, params.aug_pc_r, draws["jitter"]), PC)
    return PC, gt_R, gt_t, gt_s
