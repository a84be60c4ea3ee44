"""Denoising score-matching losses (counterpart of ``genpose_tpu/diffusion/losses.py``).

The model is a callable ``score_fn(pose, t) -> score`` that closes over the
batch's point-cloud feature.  The JAX package ``vmap``s ``repeat_num``
independent draws; here the draws are stacked into one ``[repeat * bs]``
batch and the head runs once over it, with the feature's projections tiled
to match (``score_fn`` is built with ``tile=repeat_num``).

The draws, t ~ U(eps, 1) [repeat, bs, 1] and z ~ N(0, I) [repeat, bs,
pose_dim], come from a ``torch.Generator`` or are passed in (``noise``), so
that a test can hand both packages the same numbers.

The EDM loss (``sde_mode="edm"``, JAX ``losses.py:73-112``) takes a
``denoise_fn(x, sigma) -> denoised pose`` instead, with sigma log-uniform
in [sigma_min, sigma_max] and the same stacking of draws; its draws
(sigma [repeat, bs, 1], z [repeat, bs, pose_dim]) are injectable too.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from genpose_tpu_torch.diffusion.sde import SDE


def draw_dsm_noise(sde: SDE, repeat_num: int, bs: int, pose_dim: int,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [repeat, bs, 1] ~ U(eps, 1), z [repeat, bs, pose_dim] ~ N(0, I))."""
    if generator is not None:
        device = generator.device
    u = torch.rand((repeat_num, bs, 1), generator=generator, device=device)
    t = torch.clamp(u * (1.0 - sde.eps) + sde.eps, min=sde.eps)
    z = torch.randn((repeat_num, bs, pose_dim), generator=generator, device=device)
    return t, z


def dsm_loss(score_fn: Callable, gt_pose: torch.Tensor, sde: SDE,
             teacher_score_fn: Optional[Callable] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Single-draw DSM: ``dsm_loss_repeated`` with one draw; ``noise`` is
    (t [bs, 1], z [bs, pose_dim])."""
    if noise is not None:
        noise = (noise[0][None], noise[1][None])
    return dsm_loss_repeated(score_fn, gt_pose, sde, 1, teacher_score_fn, generator, noise)


def dsm_loss_repeated(score_fn: Callable, gt_pose: torch.Tensor, sde: SDE, repeat_num: int,
                      teacher_score_fn: Optional[Callable] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Mean of ``repeat_num`` single-draw DSM losses (reference ``losses.py:47-89``,
    ``posenet_agent.py:176-197``).

    gt_pose [bs, pose_dim] zero-centred.  Per draw: x = mu + z * std with
    (mu, std) = marginal_prob(gt_pose, t); target -z / std, or the teacher's
    score at (x, t); weight std^2; the loss is the batch mean of the summed
    weighted square error.  ``score_fn`` and ``teacher_score_fn`` take the
    ``[repeat * bs]`` stack, draw r's rows at ``r * bs + b``.
    """
    bs, pose_dim = gt_pose.shape
    if noise is None:
        noise = draw_dsm_noise(sde, repeat_num, bs, pose_dim, generator, gt_pose.device)
    t, z = noise
    if t.shape != (repeat_num, bs, 1) or z.shape != (repeat_num, bs, pose_dim):
        raise ValueError(f"noise shapes {tuple(t.shape)}, {tuple(z.shape)} do not fit "
                         f"repeat {repeat_num}, batch {bs}, pose dim {pose_dim}")
    mu, std = sde.marginal_prob(gt_pose[None], t)
    x = (mu + z * std).reshape(repeat_num * bs, pose_dim)
    t_flat = t.reshape(repeat_num * bs, 1)
    estimated = score_fn(x, t_flat).reshape(repeat_num, bs, pose_dim)
    if teacher_score_fn is None:
        target = -z / std
    else:
        target = teacher_score_fn(x, t_flat).reshape(repeat_num, bs, pose_dim)
    per_draw = torch.mean(torch.sum(std ** 2 * (estimated - target) ** 2, dim=-1), dim=-1)
    return torch.mean(per_draw)


def draw_edm_noise(repeat_num: int, bs: int, pose_dim: int, sigma_min: float = 0.002,
                   sigma_max: float = 80.0, generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma [repeat, bs, 1], log-uniform in [sigma_min, sigma_max]; z
    [repeat, bs, pose_dim] ~ N(0, I)).  sigma = exp(log smin + u (log smax -
    log smin)) with u ~ U(0, 1), in float32 as the JAX loss computes it."""
    if generator is not None:
        device = generator.device
    u = torch.rand((repeat_num, bs, 1), generator=generator, device=device)
    lo, hi = torch.log(torch.tensor([sigma_min, sigma_max], dtype=torch.float32, device=device))
    sigma = torch.exp(lo + u * (hi - lo))
    z = torch.randn((repeat_num, bs, pose_dim), generator=generator, device=device)
    return sigma, z


def edm_dsm_loss(denoise_fn: Callable, gt_pose: torch.Tensor, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, generator: Optional[torch.Generator] = None,
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Single-draw EDM loss: ``edm_dsm_loss_repeated`` with one draw;
    ``noise`` is (sigma [bs, 1], z [bs, pose_dim])."""
    if noise is not None:
        noise = (noise[0][None], noise[1][None])
    return edm_dsm_loss_repeated(denoise_fn, gt_pose, 1, sigma_min, sigma_max, generator, noise)


def edm_dsm_loss_repeated(denoise_fn: Callable, gt_pose: torch.Tensor, repeat_num: int,
                          sigma_min: float = 0.002, sigma_max: float = 80.0,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Mean of ``repeat_num`` single-draw EDM losses (reference
    ``losses.py:8-44``): per draw x = y + sigma z and the batch mean of
    ||(D(x, sigma) - y) / sigma||^2, which equals the reference's
    (output sigma + z)^2 for the decoder's D = x + sigma f.  ``denoise_fn``
    takes the ``[repeat * bs]`` stack, draw r's rows at ``r * bs + b``."""
    bs, pose_dim = gt_pose.shape
    if noise is None:
        noise = draw_edm_noise(repeat_num, bs, pose_dim, sigma_min, sigma_max, generator,
                               gt_pose.device)
    sigma, z = noise
    if sigma.shape != (repeat_num, bs, 1) or z.shape != (repeat_num, bs, pose_dim):
        raise ValueError(f"noise shapes {tuple(sigma.shape)}, {tuple(z.shape)} do not fit "
                         f"repeat {repeat_num}, batch {bs}, pose dim {pose_dim}")
    x = (gt_pose[None] + z * sigma).reshape(repeat_num * bs, pose_dim)
    denoised = denoise_fn(x, sigma.reshape(repeat_num * bs, 1)).reshape(repeat_num, bs, pose_dim)
    per_draw = torch.mean(torch.sum(((denoised - gt_pose[None]) / sigma) ** 2, dim=-1), dim=-1)
    return torch.mean(per_draw)
