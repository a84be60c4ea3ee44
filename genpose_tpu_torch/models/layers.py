"""Shared layers (counterpart of ``genpose_tpu/models/layers.py``).

- ``GaussianFourierProjection`` (ref ``scorenet.py:55-64``): fixed random
  time features, stored as a buffer ``W``; always float32.
- ``PositionalEmbedding`` (ref ``scorenet.py:67-80``): the EDM decoder's
  sinusoidal sigma embedding, without parameters; always float32.
- ``Dense``: flax ``nn.Dense`` at a compute dtype.  The input and the
  float32 weight are cast to ``dtype`` at use; below float32 the bias is
  added after the matmul, in ``dtype`` (two roundings, as flax), not fused
  into the GEMM.
- ``SharedMLP`` (ref ``pytorch_utils.py:5-33``): the reference's 1x1
  Conv2d+BN+ReLU stack written as ``Dense`` over channels-last
  ``[..., C]`` tensors.  A 1x1 convolution is a feature-dim matmul, and
  ``F.linear`` keeps cuDNN (and its TF32 default) off the path.  BatchNorm
  normalises in float32 and casts back, as the JAX package's
  ``TorchBatchNorm`` does; in eval mode it uses its running statistics.
- ``SplitTail`` / ``FusedTails``: the fusion tails with the ``pts_feat``
  projection split off, so samplers compute it once per request
  (``precompute``) and reuse it at every step (``from_proj``).

Parameters stay float32 whatever the compute dtype.  Where operands of two
dtypes meet in a matmul (``FusedTails`` under ``encoder_f32_stages``: a
float32 ``pts_feat`` and a bfloat16 kernel), ``matmul`` promotes both as
``jnp.matmul`` does; ``torch.matmul`` of mixed dtypes would raise.  No
autocast: each module computes in the dtype it is given, as the flax
modules do.  ``cast_weights_`` gives a private copy of a model (the frozen
programs') its matmul weights in their compute dtype once.

Submodule and parameter names follow the flax tree (``dense_0``, ``bn_0``,
``feat_kernel``...), so ``utils/weights.py`` maps JAX parameters across by
name.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GaussianFourierProjection(nn.Module):
    """Gaussian random features for the time embedding.  t [n] -> [n, embed_dim]."""

    def __init__(self, embed_dim: int = 128, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("W", torch.randn(embed_dim // 2) * scale)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x_proj = t[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class PositionalEmbedding(nn.Module):
    """Sinusoidal embedding: x [n] -> [n, num_channels], cosines then sines
    at frequencies (1 / max_positions) ** (i / (half - endpoint))."""

    def __init__(self, num_channels: int = 128, max_positions: int = 10000,
                 endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = (
            num_channels, max_positions, endpoint)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        base = torch.tensor(1.0 / self.max_positions, dtype=torch.float32, device=x.device)
        x = x[:, None] * torch.pow(base, freqs)[None, :]
        return torch.cat([torch.cos(x), torch.sin(x)], dim=-1)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of the two, as ``jnp.einsum``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input and weight cast to ``dtype``.
    In float32 one ``F.linear``; below it the matmul, then the bias added in
    ``dtype``, as flax rounds them (``F.linear`` may fuse the bias into the
    GEMM's epilogue and round once)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if dt == torch.float32:
            return F.linear(x, self.weight, self.bias)
        y = x @ self.weight.to(dt).t()
        return y if self.bias is None else y + self.bias.to(dt)


class SharedMLP(nn.Module):
    """Per-point MLP: Dense (no bias) + BatchNorm + ReLU, channels-last.

    BatchNorm runs on the float32 view of its input and its output is cast
    back to ``dtype`` (flax's ``force_float32_reductions`` and float32
    normalisation; ``bn_dtype`` of the JAX package changes nothing here, as
    it changes nothing there: ``tests/test_precision_knobs.py``)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers, self.dtype = len(features), dtype
        c = in_features
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(c, f, bias=False, dtype=dtype))
            # torch BatchNorm2d defaults of the reference: momentum 0.1, eps 1e-5
            self.add_module(f"bn_{i}", nn.BatchNorm1d(f, eps=1e-5, momentum=0.1))
            c = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            shape = x.shape
            x = getattr(self, f"bn_{i}")(x.float().reshape(-1, shape[-1]))
            x = F.relu(x.reshape(shape).to(self.dtype))
        return x


class SplitTail(nn.Module):
    """``out(relu(Dense([pts_feat, dyn_feat])))`` with the first Dense split
    into a static ``feat`` part (no bias) and a dynamic ``dyn`` part."""

    def __init__(self, hidden: int, out_dim: int, feat_dim: int = 1024, dyn_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat = Dense(feat_dim, hidden, bias=False, dtype=dtype)
        self.dyn = Dense(dyn_dim, hidden, dtype=dtype)
        self.out = Dense(hidden, out_dim, dtype=dtype)

    def precompute(self, pts_feat: torch.Tensor) -> torch.Tensor:
        return self.feat(pts_feat)

    def from_proj(self, fp: torch.Tensor, dyn_feat: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(fp + self.dyn(dyn_feat)))


class FusedTails(nn.Module):
    """``num_tails`` parallel SplitTails as one wide matmul bank.

    The tails' first-layer kernels are one ``[in, K*H]`` matrix per input
    block (pts_feat, t, pose) and the output heads a banked ``[K, H, O]``
    einsum.  The t block may be a step-shared ``[1, t_dim]`` row that
    broadcasts over the batch.  Parameters keep the flax layout ``[in, out]``.
    The kernels are cast to ``dtype`` and meet their inputs as ``jnp``
    operators do: a float32 ``pts_feat`` makes the projection, and
    everything added to it, float32 (JAX ``layers.py:269-280``)."""

    def __init__(self, num_tails: int, hidden: int, out_dim: int, t_dim: int = 128,
                 pose_feat_dim: int = 256, feat_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_tails, self.hidden, self.out_dim, self.dtype = num_tails, hidden, out_dim, dtype
        kh = num_tails * hidden
        self.feat_kernel = nn.Parameter(torch.zeros(feat_dim, kh))
        self.t_kernel = nn.Parameter(torch.zeros(t_dim, kh))
        self.pose_kernel = nn.Parameter(torch.zeros(pose_feat_dim, kh))
        self.bias = nn.Parameter(torch.zeros(kh))
        self.out_kernel = nn.Parameter(torch.zeros(num_tails, hidden, out_dim))
        self.out_bias = nn.Parameter(torch.zeros(num_tails, out_dim))

    def precompute(self, pts_feat: torch.Tensor) -> torch.Tensor:
        return matmul(pts_feat, self.feat_kernel.to(self.dtype))

    def from_proj(self, fp: torch.Tensor, t_feat: torch.Tensor,
                  pose_feat: torch.Tensor) -> torch.Tensor:
        """fp [n, K*H]; t_feat [1 or n, t_dim]; pose_feat [n, pose_feat_dim]."""
        dt = self.dtype
        h = (fp + matmul(t_feat, self.t_kernel.to(dt)) + matmul(pose_feat, self.pose_kernel.to(dt))
             + self.bias.to(dt))
        h = F.relu(h).reshape(h.shape[0], self.num_tails, self.hidden)
        out = einsum("nkh,kho->nko", h, self.out_kernel.to(dt)) + self.out_bias.to(dt)
        return out.reshape(out.shape[0], self.num_tails * self.out_dim)


@torch.no_grad()
def cast_weights_(model: nn.Module) -> nn.Module:
    """Store every matmul weight of ``model`` in its module's compute dtype
    (the casts the forward makes at use then do nothing).  For a private
    copy that only runs inference: BatchNorm and the Fourier ``W`` stay
    float32, and the values are what the casts at use would give."""
    for m in model.modules():
        if isinstance(m, (Dense, FusedTails)) and m.dtype != torch.float32:
            for p in m.parameters(recurse=False):
                p.data = p.data.to(m.dtype)
    return model
