"""Vanilla PointNet encoder with a spatial transformer (counterpart of ``genpose_tpu/models/pointnet.py``).

Reference ``networks/pts_encoder/pointnets.py:14-123``, channels-last: each
per-point 1x1 conv is a Dense over the feature axis.  No BatchNorm (the
reference removed it, ``pointnets.py:82``).  The transformer's last layer
starts at zero, so it starts at the exact identity (JAX
``pointnet.py:31-38``; the seeded init, ``utils/weights.py::init_params_``,
zeroes it).

Submodule names follow flax's auto-names (``stn``, ``fstn``, ``Dense_0``...),
so ``utils/weights.py::from_jax_variables`` maps the JAX tree by name.
Every Dense computes in ``dtype``; the alignment products promote their
operands as ``jnp.einsum`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genpose_tpu_torch.models.layers import Dense, einsum


class STNkd(nn.Module):
    """Spatial transformer: x [B, N, k] -> a k x k alignment matrix [B, k, k]
    (ref ``pointnets.py:45-79``)."""

    WIDTHS = (64, 128, 1024, 512, 256)

    def __init__(self, k: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        c = k
        for i, w in enumerate(self.WIDTHS + (k * k,)):
            self.add_module(f"Dense_{i}", Dense(c, w, dtype=dtype))
            c = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(3):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        h = torch.amax(h, dim=1)  # [B, 1024]
        for i in (3, 4):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        h = self.Dense_5(h)
        iden = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(-1)
        return (h + iden).reshape(-1, self.k, self.k)


class PointNetfeat(nn.Module):
    """Global PointNet feature (ref ``pointnets.py:83-123``):
    [B, N, in_dim] -> [B, out_dim].  ``feature_transform`` adds the 64-d
    transformer ``fstn`` after the first Dense."""

    def __init__(self, in_dim: int = 3, out_dim: int = 1024, feature_transform: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stn = STNkd(k=in_dim, dtype=dtype)
        self.fstn = STNkd(k=64, dtype=dtype) if feature_transform else None
        c = in_dim
        for i, w in enumerate((64, 128, 512, out_dim)):
            self.add_module(f"Dense_{i}", Dense(c, w, dtype=dtype))
            c = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = einsum("bnk,bkj->bnj", x, self.stn(x))
        x = F.relu(self.Dense_0(x))
        if self.fstn is not None:
            x = einsum("bnk,bkj->bnj", x, self.fstn(x))
        x = F.relu(self.Dense_1(x))
        x = F.relu(self.Dense_2(x))
        return torch.amax(self.Dense_3(x), dim=1)  # [B, out_dim]
