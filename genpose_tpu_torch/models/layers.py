"""Shared layers (counterpart of ``genpose_tpu/models/layers.py``).

- ``GaussianFourierProjection`` (ref ``scorenet.py:55-64``): fixed random
  time features, stored as a buffer ``W``; always float32.
- ``PositionalEmbedding`` (ref ``scorenet.py:67-80``): the EDM decoder's
  sinusoidal sigma embedding, without parameters; always float32.
- ``Dense``: flax ``nn.Dense`` at a compute dtype.  The input and the
  float32 weight are cast to ``dtype`` at use; below float32 the bias is
  added after the matmul, in ``dtype`` (two roundings, as flax), not fused
  into the GEMM.
- ``MLP``: the JAX package's Dense -> ReLU stack (no norm), its Dense
  layers named ``dense_{i}`` as in the flax tree.
- ``SharedMLP`` (ref ``pytorch_utils.py:5-33``): the reference's 1x1
  Conv2d+BN+ReLU stack written as ``Dense`` over channels-last
  ``[..., C]`` tensors.  A 1x1 convolution is a feature-dim matmul, and
  ``F.linear`` keeps cuDNN (and its TF32 default) off the path.  BatchNorm
  normalises in float32 and casts back, as the JAX package's
  ``TorchBatchNorm`` does; in eval mode it uses its running statistics.
  Inside ``parallel.sharded`` train-mode BatchNorm takes the statistics of
  the global batch (``global_batch_norm``).
- ``SplitTail`` / ``FusedTails``: the fusion tails with the ``pts_feat``
  projection split off, so samplers compute it once per request
  (``precompute``) and reuse it at every step (``from_proj``).
- ``PerPointTail`` (ref ``rot_head.py:8-35``, ``trans_head.py:10-41``): the
  decoder tail over per-point features, conv1's kernel stored as
  [pts, t, pose] row blocks so its pts part is precomputed the same way.
  Dropout draws from an explicit ``torch.Generator``, in train mode only.

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

from genpose_tpu_torch.parallel import group as parallel


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
        # a fill on the device, not a copy from the host: safe inside a CUDA graph capture
        base = torch.full((), 1.0 / self.max_positions, dtype=torch.float32, device=x.device)
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


class MLP(nn.Module):
    """Dense -> ReLU for each width of ``features`` (no norm; flax ``MLP``
    of ``genpose_tpu/models/layers.py``)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = len(features)
        c = in_features
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(c, f, dtype=dtype))
            c = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return x


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
            x = F.relu(batch_norm(getattr(self, f"bn_{i}"), getattr(self, f"dense_{i}")(x)))
        return x


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` over the last axis of ``x`` [..., C], normalised in float32
    and cast back to ``x``'s dtype; in train mode inside
    ``parallel.sharded(group)`` of two or more ranks over the group's
    global batch."""
    rows = x.float().reshape(-1, x.shape[-1])
    group = parallel.active()
    if group is None or group.world == 1 or not bn.training:
        y = bn(rows)
    else:
        y = global_batch_norm(bn, rows, group)
    return y.reshape(x.shape).to(x.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation of rows [n, C] over every rank of a
    group, its backward written out (SyncBatchNorm's algorithm in plain
    PyTorch): the forward all-reduces the per-channel sum and row count,
    then the sum of squared deviations; the backward all-reduces the sums
    of the output gradient and of its product with the normalised input,
    so the input gradient is that of the global statistics.  Saves the
    input, mean and inverse deviation only, as ``nn.BatchNorm1d`` does."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        stats = parallel.all_reduce_(torch.cat([x.sum(0), x.new_full((1,), x.shape[0])]), group)
        n = stats[c:]
        mean = stats[:c] / n
        d = x - mean
        var = parallel.all_reduce_((d * d).sum(0), group) / n
        invstd = 1.0 / torch.sqrt(var + eps)
        y = d * invstd * weight + bias  # as PyTorch's CUDA kernel normalises
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, _mean, _var, _n):
        x, mean, invstd, weight = ctx.saved_tensors
        c = x.shape[1]
        xhat = (x - mean) * invstd
        sum_dy, sum_dy_xhat = gy.sum(0), (gy * xhat).sum(0)
        total = parallel.all_reduce_(torch.cat([sum_dy, sum_dy_xhat]), ctx.group) / ctx.n
        gx = (weight * invstd) * (gy - total[:c] - xhat * total[c:])
        return gx, sum_dy_xhat, sum_dy, None, None


def global_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, group) -> torch.Tensor:
    """Train-mode ``bn`` over the rows [n, C] of every rank of ``group``
    (the JAX mesh's global statistics, ``TorchBatchNorm``'s semantics, JAX
    ``layers.py:71-111``; ``_GlobalBatchNorm``): the mean and the biased
    variance of the global batch, the variance from the squared deviations
    as ``nn.BatchNorm1d`` takes it in two passes (one all-reduce of the sum
    and the sum of squares, E[x^2] - E[x]^2 as flax takes it, cancels
    digits), the output in the form PyTorch's CUDA kernel uses; the running
    statistics updated on every rank with the mean and the unbiased
    variance."""
    y, mean, var, n = _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps, group)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean * m)
        bn.running_var.mul_(1 - m).add_(var * (n / (n - 1)) * m)
        bn.num_batches_tracked.add_(1)
    return y


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: each entry kept with probability 1 - rate and
    scaled by 1 / (1 - rate), the mask drawn from ``generator`` (inside
    ``parallel.sharded``, the global batch's mask, this rank's rows)."""
    keep = 1.0 - rate
    mask = parallel.local_draw(
        lambda n: torch.rand((n, *x.shape[1:]), generator=generator, device=x.device),
        x.shape[0]) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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


class PerPointTail(nn.Module):
    """RotHead / TransHead decoder tail over per-point features,
    channels-last: ``conv1(f -> 1024) + bn1 + relu -> conv2(1024 -> 256) +
    bn2 + relu -> max over points -> conv3(256 -> 256) + bn3 + relu ->
    dropout(0.2) -> conv4(256 -> out)``, every conv a 1x1 Conv1d, i.e. a
    Dense.  conv1 is linear over the ``[pts_feat, t_feat, pose_feat]``
    channel blocks (ref ``scorenet.py:198-204``), so its kernel is three row
    blocks (flax layout ``[in, out]``) and ``bias1``; the pts block is
    loop-invariant in a sampler and computed by ``precompute``.  BatchNorm:
    torch's momentum 0.1 (flax 0.9) and eps 1e-5, float32 normalisation;
    in train mode it uses batch statistics and dropout applies when a
    generator is given (JAX: when the caller supplies a dropout rng)."""

    def __init__(self, pts_dim: int = 1280, t_dim: int = 128, pose_feat_dim: int = 256,
                 out_dim: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.feat_kernel = nn.Parameter(torch.zeros(pts_dim, 1024))
        self.t_kernel = nn.Parameter(torch.zeros(t_dim, 1024))
        self.pose_kernel = nn.Parameter(torch.zeros(pose_feat_dim, 1024))
        self.bias1 = nn.Parameter(torch.zeros(1024))
        for name, width in (("bn1", 1024), ("bn2", 256), ("bn3", 256)):
            self.add_module(name, nn.BatchNorm1d(width, eps=1e-5, momentum=0.1))
        self.conv2 = Dense(1024, 256, dtype=dtype)
        self.conv3 = Dense(256, 256, dtype=dtype)
        self.conv4 = Dense(256, out_dim, dtype=dtype)

    def precompute(self, pts_feat: torch.Tensor) -> torch.Tensor:
        """pts_feat [bs, N, pts_dim] -> conv1's static part [bs, N, 1024]."""
        return matmul(pts_feat, self.feat_kernel.to(self.dtype))

    def from_proj(self, fp: torch.Tensor, t_feat: torch.Tensor, pose_feat: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
        """fp [bs, N, 1024]; t_feat [1 or bs, t_dim]; pose_feat [bs, pose_feat_dim]."""
        dt = self.dtype
        dyn = (matmul(t_feat, self.t_kernel.to(dt)) + matmul(pose_feat, self.pose_kernel.to(dt))
               + self.bias1.to(dt))
        h = F.relu(batch_norm(self.bn1, fp + dyn[:, None, :]))
        h = F.relu(batch_norm(self.bn2, self.conv2(h)))
        h = torch.amax(h, dim=1)  # max-pool over points (rot_head.py:26)
        h = F.relu(batch_norm(self.bn3, self.conv3(h)))
        if self.training and generator is not None:
            h = dropout(h, 0.2, generator)
        return self.conv4(h)


@torch.no_grad()
def cast_weights_(model: nn.Module) -> nn.Module:
    """Store every matmul weight of ``model`` in its module's compute dtype
    (the casts the forward makes at use then do nothing).  For a private
    copy that only runs inference: BatchNorm and the Fourier ``W`` stay
    float32, and the values are what the casts at use would give."""
    for m in model.modules():
        if isinstance(m, (Dense, FusedTails, PerPointTail)) and m.dtype != torch.float32:
            for p in m.parameters(recurse=False):
                p.data = p.data.to(m.dtype)
    return model
