"""GenPose++'s frozen image tower and the lifting of its features to the points.

GenPose++ (Omni6DPose, Zhang et al., ECCV 2024; ``github.com/Omni6DPose/GenPose2``)
feeds PointNet++ semantic features from a frozen DINOv2 ViT-S/14 (Oquab et
al., arXiv:2304.07193; ``facebookresearch/dinov2`` hubconf ``dinov2_vits14``,
without registers) run over the object's RGB crop.  The tower here:

- input: a crop [B, 3, S, S] in [0, 1], normalised with ImageNet's mean and
  std (``normalize_crops`` takes the loader's uint8 [B, S, S, 3]);
- patch embedding: a 14 x 14 stride-14 convolution with bias, written as
  one matrix product over the unfolded patches ((S / 14)^2 patches of 588
  values); the CLS token prepended and ``pos_embed`` added;
- ``depth`` pre-norm blocks with LayerScale:
  ``h += ls1 * Attn(LN1(h)); h += ls2 * MLP(LN2(h))``, LayerNorm eps 1e-6;
  Attn: ``qkv`` Linear(384, 1152), 6 heads of 64, ``softmax(q k^T / 8) v``
  as explicit matrix products, ``proj`` Linear(384, 384); MLP: Linear(384,
  1536), exact (erf) GELU, Linear(1536, 384);
- output: a final LayerNorm; the patch tokens as a grid [B, 384, S/14, S/14].

The weights are buffers named as DINOv2's ``state_dict`` names them
(``blocks.3.attn.qkv.weight``, ``blocks.3.ls1.gamma``...), so that no
optimizer, EMA shadow or gradient reaches them: the tower is frozen.
``pos_embed`` holds 1 + (S / 14)^2 rows, so a checkpoint's 37 x 37 table is
resampled once at load.  ``reset_`` draws seeded weights (LayerScale at 1,
not at the 1e-5 of DINOv2's initialisation, so that seeded blocks do real
work).

``lift_features``: point n with crop pixel (u, v) (continuous, the crop's
left and top edges at 0) takes the bilinear sample of the grid at (u, v),
patch i's centre lying at 14 i + 7; beyond the outermost centres the border
value holds.  That is ``F.grid_sample`` at (2u / S - 1, 2v / S - 1),
``align_corners=False``, ``padding_mode="border"``.

All of it is float32 (TF32 is off at the package's import).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

PATCH, WIDTH, HEADS, MLP_WIDTH, DEPTH, CROP = 14, 384, 6, 1536, 12, 224
LN_EPS = 1e-6
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def normalize_crops(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 crops [B, S, S, 3] -> float32 [B, 3, S, S], ImageNet-normalised."""
    x = rgb.to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def _buffers(**shapes) -> nn.Module:
    """A module holding zero buffers of the given shapes under the given names."""
    m = nn.Module()
    for name, shape in shapes.items():
        m.register_buffer(name, torch.zeros(shape))
    return m


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm1 = _buffers(weight=WIDTH, bias=WIDTH)
        self.attn = nn.Module()
        self.attn.qkv = _buffers(weight=(3 * WIDTH, WIDTH), bias=3 * WIDTH)
        self.attn.proj = _buffers(weight=(WIDTH, WIDTH), bias=WIDTH)
        self.ls1 = _buffers(gamma=WIDTH)
        self.norm2 = _buffers(weight=WIDTH, bias=WIDTH)
        self.mlp = nn.Module()
        self.mlp.fc1 = _buffers(weight=(MLP_WIDTH, WIDTH), bias=MLP_WIDTH)
        self.mlp.fc2 = _buffers(weight=(WIDTH, MLP_WIDTH), bias=WIDTH)
        self.ls2 = _buffers(gamma=WIDTH)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, T, _ = h.shape
        y = F.layer_norm(h, (WIDTH,), self.norm1.weight, self.norm1.bias, LN_EPS)
        qkv = F.linear(y, self.attn.qkv.weight, self.attn.qkv.bias)
        q, k, v = qkv.reshape(B, T, 3, HEADS, WIDTH // HEADS).permute(2, 0, 3, 1, 4)
        a = torch.softmax((q * (WIDTH // HEADS) ** -0.5) @ k.transpose(-1, -2), dim=-1)
        o = (a @ v).transpose(1, 2).reshape(B, T, WIDTH)
        h = h + self.ls1.gamma * F.linear(o, self.attn.proj.weight, self.attn.proj.bias)
        y = F.layer_norm(h, (WIDTH,), self.norm2.weight, self.norm2.bias, LN_EPS)
        y = F.gelu(F.linear(y, self.mlp.fc1.weight, self.mlp.fc1.bias))
        return h + self.ls2.gamma * F.linear(y, self.mlp.fc2.weight, self.mlp.fc2.bias)


class ImageTower(nn.Module):
    """DINOv2 ViT-S/14 over crops of ``crop`` pixels, ``depth`` blocks:
    normalised crops [B, 3, crop, crop] -> patch grid [B, 384, crop / 14,
    crop / 14].  Frozen: every weight is a buffer."""

    def __init__(self, depth: int = DEPTH, crop: int = CROP):
        super().__init__()
        if crop % PATCH:
            raise ValueError(f"a crop of {crop} px is not a whole number of {PATCH}-px patches")
        self.depth, self.crop, self.side = depth, crop, crop // PATCH
        self.register_buffer("cls_token", torch.zeros(1, 1, WIDTH))
        self.register_buffer("pos_embed", torch.zeros(1, 1 + self.side ** 2, WIDTH))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = _buffers(weight=(WIDTH, 3, PATCH, PATCH), bias=WIDTH)
        self.blocks = nn.ModuleList(_Block() for _ in range(depth))
        self.norm = _buffers(weight=WIDTH, bias=WIDTH)

    @torch.no_grad()
    def reset_(self, generator: torch.Generator) -> "ImageTower":
        """Seeded weights: Linear and patch weights normal with std
        1 / sqrt(fan in), biases 0, LayerNorm 1 / 0, LayerScale 1, the CLS
        token and ``pos_embed`` normal with std 0.02."""
        def normal_(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        for name, t in self.named_buffers():
            if name in ("cls_token", "pos_embed"):
                normal_(t, 0.02)
            elif name.endswith(".bias"):
                t.zero_()
            elif name.endswith(".gamma") or name.split(".")[-2].startswith("norm"):
                t.fill_(1.0)
            else:  # a Linear or the patch embedding
                normal_(t, 1.0 / math.sqrt(t[0].numel()))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, s = x.shape[0], self.side
        patches = (x.reshape(B, 3, s, PATCH, s, PATCH).permute(0, 2, 4, 1, 3, 5)
                   .reshape(B, s * s, 3 * PATCH * PATCH))
        proj = self.patch_embed.proj
        h = F.linear(patches, proj.weight.reshape(WIDTH, -1), proj.bias)
        h = torch.cat([self.cls_token.expand(B, 1, WIDTH), h], dim=1) + self.pos_embed
        for block in self.blocks:
            h = block(h)
        h = F.layer_norm(h, (WIDTH,), self.norm.weight, self.norm.bias, LN_EPS)
        return h[:, 1:].transpose(1, 2).reshape(B, WIDTH, s, s)


def lift_features(grid: torch.Tensor, pix: torch.Tensor, crop: int) -> torch.Tensor:
    """Patch grid [B, C, s, s] and the points' crop pixels [B, N, 2] (u, v)
    -> per-point features [B, N, C], bilinear with the border held."""
    where = pix.to(grid.dtype) * 2.0 / crop - 1.0
    out = F.grid_sample(grid, where[:, None], mode="bilinear", padding_mode="border",
                        align_corners=False)                        # [B, C, 1, N]
    return out[:, :, 0].transpose(1, 2).contiguous()
