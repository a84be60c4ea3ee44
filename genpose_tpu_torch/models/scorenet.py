"""Pose score network (counterpart of ``genpose_tpu/models/scorenet.py``).

MLP conditioned on (pts_feat [1024], pose [pose_dim], t):

- pose encoder pose_dim -> 256 -> 256 (ReLU);
- Gaussian-Fourier t-embedding 128 -> Linear 128 + ReLU;
- fusion tails over ``[pts_feat, t_feat, pose_feat]`` with zero-initialised
  last layers, output divided by sigma(t) + 1e-7 (ref ``scorenet.py:205-217``).

Identical tail shapes fuse into one ``FusedTails`` bank (``Rx_Ry_and_T`` ->
3 x 256); other heads are a list of ``SplitTail``s.  ``PoseDecoderNet`` is
the EDM denoiser head over the same tails (``sde_mode="edm"`` score models).
With ``per_point_feature`` the trunk takes per-point features
[bs, N, pts_feat_dim] and its tails are ``PerPointTail`` decoder heads
(ref ``scorenet.py:86,146-149``; ``Rx_Ry_and_T`` only, as there).  As in
the JAX package, a score net built directly selects it; the composite
model does not wire it (the reference hardcodes it off, ``posenet.py:57``).

``dtype`` is the head's compute dtype (``head_dtype``): ``t_dense``,
``pose_dense_0/1`` and the tails compute in it; the Fourier features stay
float32.  The score divides by a 2-D ``std`` column, so it is float32 under
any head dtype, as in JAX (a 0-dim float32 divisor would leave a bfloat16
quotient bfloat16 in PyTorch).

On a card, ``PoseScoreNet.score_from`` computes a whole evaluation in one
hand-written kernel (``ops/score_head_cuda.py``) when its inputs show the
float32 fused-tail head at a step-shared t without autograd
(``fused_head_applies``): the samplers' evaluations.  Everything else
(training's per-row t, the likelihood's gradients, bfloat16 heads, split
or per-point tails, the CPU) runs the plain arithmetic.  The counters
``score_head.fused`` and ``score_head.plain`` of ``utils/trace.py`` count
the calls of each path.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from genpose_tpu_torch.models.layers import (
    Dense,
    FusedTails,
    GaussianFourierProjection,
    PerPointTail,
    PositionalEmbedding,
    SplitTail,
)
from genpose_tpu_torch.ops import score_head_cuda
from genpose_tpu_torch.ops.pose import get_pose_dim
from genpose_tpu_torch.utils import trace


def _tail_specs(regression_head: str, pose_dim: int):
    """(name, hidden, out_dim) per fusion tail (ref ``scorenet.py:118-176``)."""
    if regression_head == "RT":
        return (("tail", 512, pose_dim),)
    if regression_head == "R_and_T":
        return (("tail_rot", 256, pose_dim - 3), ("tail_trans", 256, 3))
    if regression_head == "Rx_Ry_and_T":
        return (("tail_rot_x", 256, 3), ("tail_rot_y", 256, 3), ("tail_trans", 256, 3))
    raise NotImplementedError(regression_head)


class _TailBank(nn.Module):
    """The fusion tails over ``[pts_feat, embed_feat, pose_feat]`` shared by
    ``PoseTrunk`` (score / energy) and ``PoseDecoderNet`` (EDM): identical
    tail shapes fuse into one ``FusedTails`` bank named ``tails``, otherwise
    one ``SplitTail`` per spec under its own name (the flax tree's names)."""

    def _build_tails(self, specs, dtype: torch.dtype) -> None:
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

    def _tails_from_proj(self, projs, embed_feat: torch.Tensor,
                         pose_feat: torch.Tensor) -> torch.Tensor:
        """The tails' output; the t / sigma embedding may be a step-shared
        [1, C] row, broadcast through the fused bank or expanded for the
        split tails' concat."""
        if self.tail_names is None:
            return self.tails.from_proj(projs, embed_feat, pose_feat)
        if embed_feat.shape[0] != pose_feat.shape[0]:
            embed_feat = embed_feat.expand(pose_feat.shape[0], embed_feat.shape[1])
        dyn_feat = torch.cat([embed_feat, pose_feat], dim=-1)
        return torch.cat([getattr(self, n).from_proj(fp, dyn_feat)
                          for n, fp in zip(self.tail_names, projs)], dim=-1)


class PoseTrunk(_TailBank):
    """Shared (t, pose) conditioning trunk + fusion tails, used by the score
    and energy heads.  ``precompute`` hoists the pts_feat projections out of
    the sampler's step loop.  ``per_point_feature``: ``PerPointTail`` tails
    over per-point features of ``pts_feat_dim`` channels."""

    def __init__(self, pose_mode: str = "rot_matrix", regression_head: str = "Rx_Ry_and_T",
                 dtype: torch.dtype = torch.float32, per_point_feature: bool = False,
                 pts_feat_dim: int = 1280):
        super().__init__()
        pose_dim = get_pose_dim(pose_mode)
        if regression_head == "Rx_Ry_and_T" and pose_mode != "rot_matrix":
            raise NotImplementedError("Rx_Ry_and_T requires rot_matrix pose mode")
        self.t_fourier = GaussianFourierProjection(embed_dim=128)
        self.t_dense = Dense(128, 128, dtype=dtype)
        self.pose_dense_0 = Dense(pose_dim, 256, dtype=dtype)
        self.pose_dense_1 = Dense(256, 256, dtype=dtype)
        specs = _tail_specs(regression_head, pose_dim)
        self.per_point_feature = per_point_feature
        if per_point_feature:
            # the reference wires per-point heads only for Rx_Ry_and_T
            # (scorenet.py:146-149)
            if regression_head != "Rx_Ry_and_T":
                raise NotImplementedError("per_point_feature requires Rx_Ry_and_T")
            self.tail_names = tuple(name for name, _, _ in specs)
            for name, _, out_dim in specs:
                self.add_module(name, PerPointTail(pts_dim=pts_feat_dim, out_dim=out_dim,
                                                   dtype=dtype))
        else:
            self._build_tails(specs, dtype)

    def f_theta_from(self, projs, sampled_pose: torch.Tensor, t: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Head output given precomputed projections.  t is [n, 1], or a
        step-shared [1, 1] that broadcasts through the fused bank.
        ``generator``: the per-point tails' dropout draws in train mode."""
        t_feat = F.relu(self.t_dense(self.t_fourier(t[:, 0])))
        pose_feat = F.relu(self.pose_dense_0(sampled_pose))
        pose_feat = F.relu(self.pose_dense_1(pose_feat))
        if self.per_point_feature:
            return torch.cat([getattr(self, n).from_proj(fp, t_feat, pose_feat, generator)
                              for n, fp in zip(self.tail_names, projs)], dim=-1)
        return self._tails_from_proj(projs, t_feat, pose_feat)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def fused_head_applies(trunk: PoseTrunk, projs, sampled_pose: torch.Tensor,
                       t: torch.Tensor) -> bool:
    """Whether a score evaluation takes the fused kernel: a float32
    ``FusedTails`` bank (not split or per-point tails), float32 CUDA inputs,
    a step-shared t [1, 1] and no autograd graph to record."""
    tails = getattr(trunk, "tails", None)
    return (isinstance(tails, FusedTails) and tails.dtype == torch.float32
            and _on_card(sampled_pose) and not torch.is_grad_enabled()
            and tuple(t.shape) == (1, 1) and t.dtype == torch.float32
            and sampled_pose.dtype == torch.float32 and projs.dtype == torch.float32)


class PoseScoreNet(nn.Module):
    """The score head: the trunk's output over sigma(t) + 1e-7.
    ``per_point_feature`` as ``PoseTrunk``'s."""

    def __init__(self, marginal_prob_fn: Callable, pose_mode: str = "rot_matrix",
                 regression_head: str = "Rx_Ry_and_T", dtype: torch.dtype = torch.float32,
                 per_point_feature: bool = False, pts_feat_dim: int = 1280):
        super().__init__()
        self.marginal_prob_fn = marginal_prob_fn
        self.trunk = PoseTrunk(pose_mode=pose_mode, regression_head=regression_head, dtype=dtype,
                               per_point_feature=per_point_feature, pts_feat_dim=pts_feat_dim)

    def precompute(self, pts_feat):
        return self.trunk.precompute(pts_feat)

    def score_from(self, projs, sampled_pose, t, generator: Optional[torch.Generator] = None):
        _, std = self.marginal_prob_fn(None, t)
        std = torch.reshape(std, (-1, 1))
        if fused_head_applies(self.trunk, projs, sampled_pose, t):
            trace.count("score_head.fused")
            return score_head_cuda.score_head(self.trunk, projs.contiguous(),
                                              sampled_pose.contiguous(), t, std)
        trace.count("score_head.plain")
        return self.trunk.f_theta_from(projs, sampled_pose, t, generator) / (std + 1e-7)


class PoseDecoderNet(_TailBank):
    """EDM denoiser head ``D(x, sigma) = x + sigma * f_theta(x, sigma)``
    (JAX ``scorenet.py:180-247``; ref ``scorenet.py:225-364``), with the
    VE-style scaling branch the reference keeps active: c_skip = 1,
    c_out = sigma, c_in = 1, c_noise = log(sigma / 2).

    The sigma embedding is ``PositionalEmbedding`` (no parameters) then
    ``sigma_dense``; pose encoder and tails as the score trunk, over
    ``[pts_feat, sigma_feat, pose_feat]``.  The parameters sit directly
    under the head (no ``trunk``), as in the flax tree, so
    ``utils/weights.py::from_jax_variables`` and
    ``utils/torch_port.py::port_decoder`` fill them by name.  ``precompute``
    hoists the pts_feat projections; ``denoise_from`` and ``score_from``
    take them, with sigma as [n, 1] or a step-shared [1, 1]."""

    def __init__(self, marginal_prob_fn: Callable, pose_mode: str = "rot_matrix",
                 regression_head: str = "Rx_Ry_and_T", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.marginal_prob_fn = marginal_prob_fn
        pose_dim = get_pose_dim(pose_mode)
        self.sigma_embed = PositionalEmbedding(num_channels=128)
        self.sigma_dense = Dense(128, 128, dtype=dtype)
        self.pose_dense_0 = Dense(pose_dim, 256, dtype=dtype)
        self.pose_dense_1 = Dense(256, 256, dtype=dtype)
        self._build_tails(_tail_specs(regression_head, pose_dim), dtype)

    def _f_theta_from(self, projs, sampled_pose, t):
        _, sigma_t = self.marginal_prob_fn(None, t)
        sigma_t = torch.reshape(sigma_t, (-1, 1))
        c_noise = torch.log(sigma_t / 2.0)
        sig_feat = F.relu(self.sigma_dense(self.sigma_embed(c_noise[:, 0])))
        pose_feat = F.relu(self.pose_dense_0(sampled_pose))
        pose_feat = F.relu(self.pose_dense_1(pose_feat))
        return sigma_t, self._tails_from_proj(projs, sig_feat, pose_feat)

    def denoise_from(self, projs, sampled_pose, t):
        """The denoised pose: c_skip x + c_out f."""
        sigma_t, f = self._f_theta_from(projs, sampled_pose, t)
        return sampled_pose + sigma_t * f

    def score_from(self, projs, sampled_pose, t):
        """The score of the implied marginal, (D - x) / sigma^2 = f / sigma,
        so the PF-ODE and PC samplers drive a decoder head too."""
        sigma_t, f = self._f_theta_from(projs, sampled_pose, t)
        return f / sigma_t
