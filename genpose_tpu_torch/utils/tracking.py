"""Pose-prior noise for tracking (counterpart of ``genpose_tpu/utils/tracking.py``,
itself after the reference's ``utils/tracking_utils.py`` and CAPTRA).

``add_noise_to_RT`` turns each rotation by |N(0,1)| * 5 deg toward a random
orthogonal quaternion direction and moves each translation along a random
direction by N(0,1) * 3 cm (ref ``tracking_utils.py:87-102``).  The draws
come from a ``torch.Generator``, or are handed in as
``(theta, norm, direction, rand_q)`` so that a test can give the JAX
package's draws.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from genpose_tpu_torch.ops.pose import matrix_to_quat_wxyz, quat_wxyz_to_matrix


def _normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-9)


def jitter_quaternion(q: torch.Tensor, theta: torch.Tensor, rand_q: torch.Tensor) -> torch.Tensor:
    """Rotate unit quaternions q [B, 4] by angle theta [B, 1] toward the
    part of ``rand_q`` [B, 4] orthogonal to q (ref ``tracking_utils.py:40-50``)."""
    rand_q = _normalize(rand_q)
    dot = torch.sum(q * rand_q, dim=-1, keepdim=True)
    q_orth = _normalize(rand_q - q * dot)
    return q * torch.cos(theta / 2) + q_orth * torch.sin(theta / 2)


def noise_draws(B: int, noise_type: str = "normal", r_deg: float = 5.0, t: float = 0.03,
                generator: Optional[torch.Generator] = None, device=None):
    """(theta [B] rad, norm [B] m, direction [B, 3], rand_q [B, 4]) for
    ``add_noise_to_RT``."""
    rad = r_deg / 180.0 * math.pi
    kw = dict(generator=generator, device=device)
    if noise_type == "normal":
        theta = torch.abs(torch.randn(B, **kw)) * rad
        norm = torch.randn(B, **kw) * t
        direction = torch.randn(B, 3, **kw)
    elif noise_type == "uniform":
        theta = torch.rand(B, **kw) * rad
        norm = (torch.rand(B, **kw) * 2 - 1) * t
        direction = torch.rand(B, 3, **kw) * 2 - 1
    else:
        raise NotImplementedError(noise_type)
    return theta, norm, direction, torch.randn(B, 4, **kw)


def add_noise_to_RT(RT: torch.Tensor, noise_type: str = "normal", r_deg: float = 5.0,
                    t: float = 0.03, generator: Optional[torch.Generator] = None,
                    draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Noise a batch of 4x4 poses [B, 4, 4] (ref ``tracking_utils.py:87-102``).
    ``draws``: (theta, norm, direction, rand_q) as ``noise_draws`` makes
    them, else drawn from ``generator``."""
    B = RT.shape[0]
    if draws is None:
        draws = noise_draws(B, noise_type, r_deg, t, generator, RT.device)
    theta, norm, direction, rand_q = (torch.as_tensor(d, dtype=RT.dtype).to(RT.device)
                                      for d in draws)
    quat = matrix_to_quat_wxyz(RT[:, :3, :3])
    new_R = quat_wxyz_to_matrix(jitter_quaternion(quat, theta[:, None], rand_q))
    direction = direction / torch.clamp(
        torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-9)
    new_t = RT[:, :3, 3] + direction * norm[:, None]
    out = RT.clone()
    out[:, :3, :3] = new_R
    out[:, :3, 3] = new_t
    return out


def srt_to_pose9d(sRT: torch.Tensor) -> torch.Tensor:
    """4x4 pose -> 9D (col0, col1, t) start vector for the sampler
    (ref ``evaluation_tracking.py:309``)."""
    return sRT[:, :3, [0, 1, 3]].transpose(1, 2).reshape(sRT.shape[0], -1)
