"""GenPose++'s semantic encoder over GenPose, in plain PyTorch: the
benchmark's frozen reference for ``pts_encoder="dinov2_pointnet2"``.

Written from the published descriptions (Zhang et al., "Omni6DPose: A
Benchmark and Model for Universal 6D Object Pose Estimation and Tracking",
ECCV 2024, code ``github.com/Omni6DPose/GenPose2``; Oquab et al., "DINOv2:
Learning Robust Visual Features without Supervision", arXiv:2304.07193,
``facebookresearch/dinov2`` ``dinov2_vits14``), not from the program under
test: it imports nothing of ``genpose_tpu_torch`` or ``genpose_tpu``.  The
GenPose parts (geometry, heads, VE SDE, Heun sampler, energies, DSM loss,
clip, Adam and EMA) are ``genpose_ref.py``'s, by import.  Every tensor is
float32 and every matrix product goes through ``Ref.mm`` (TF32 off, or its
operands rounded to TF32 for the control); no ``scaled_dot_product_attention``,
no ``F.layer_norm``, no ``F.grid_sample``: each is written out.

What is here:

- the image tower, DINOv2 ViT-S/14 without registers: ImageNet
  normalisation of the uint8 crop; the 14 x 14 stride-14 patch embedding as
  a product over unfolded patches; the CLS token and ``pos_embed``; pre-norm
  blocks ``h += ls1 * Attn(LN1(h)); h += ls2 * MLP(LN2(h))`` (LayerNorm eps
  1e-6; 6 heads of 64, ``softmax(q k^T / 8) v``; Linear, exact erf GELU,
  Linear); the final LayerNorm; the patch tokens as a grid.  The depth is
  the number of blocks in the weights and the patch grid follows the crop,
  so the tests run it at 2 blocks and 56-px crops;
- the lifting: point n with crop pixel (u, v) takes the bilinear sample of
  the grid at (u / 14 - 1/2, v / 14 - 1/2), the coordinates clamped to the
  outermost patch centres;
- the encoder: PointNet++ MSG whose stage 0 groups [dxyz ; f_j], 3 + 384
  channels; the rest as ``genpose_ref``.  The lifted features ride as
  channels after xyz in the clouds that ``train`` takes, so that
  ``genpose_ref.Ref.train`` steps them unchanged.

Departures, each also in the configuration's ``assumed``: the features
enter SA stage 0 as per-point input channels (GenPose2's own sampling of
them is not checked here); the tower is frozen, outside Adam and the EMA,
and runs without grad; ``pos_embed`` has 1 + (crop / 14)^2 rows (a
checkpoint's 37 x 37 table would be resampled once at load); GenPose's IP
energy ranking stands in for GenPose++'s clustering, and there is no scale
net.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from . import genpose_ref as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32
PATCH, WIDTH, HEADS, MLP_WIDTH = 14, 384, 6, 1536
LN_EPS = 1e-6
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
TOWER = "image_tower"
# what the configuration file gives the tower, as this file computes it
TOWER_KEYS = {"patch_size": PATCH, "embed_dim": WIDTH, "num_heads": HEADS,
              "mlp_dim": MLP_WIDTH, "layer_norm_eps": LN_EPS, "registers": 0}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def encoder_widths(stages: Dict, in_features: int) -> List[Tuple[int, int, List[int]]]:
    """(stage, scale, [in, w1, w2, ...]) of every SharedMLP, stage 0 taking
    3 + ``in_features`` channels."""
    out, c = [], in_features
    for k, mlps in enumerate(stages["MLPS"]):
        for i, mlp in enumerate(mlps):
            out.append((k, i, [c + 3, *mlp]))
        c = sum(m[-1] for m in mlps)
    if c != ref.FEAT_DIM:
        raise ValueError(f"the encoder ends in {c} channels, the heads take {ref.FEAT_DIM}")
    return out


def tower_spec(depth: int, crop: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of the tower, named as DINOv2's ``state_dict``
    under ``image_tower.``.  init: ``fan_in`` (normal, std 1/sqrt(fan in)),
    ``bias``, ``norm`` (LayerNorm weights), ``gamma`` (LayerScale),
    ``embed`` (CLS token, ``pos_embed``)."""
    t = TOWER
    side = crop // PATCH
    spec = [(f"{t}.cls_token", (1, 1, WIDTH), "embed"),
            (f"{t}.pos_embed", (1, 1 + side * side, WIDTH), "embed"),
            (f"{t}.patch_embed.proj.weight", (WIDTH, 3, PATCH, PATCH), "fan_in"),
            (f"{t}.patch_embed.proj.bias", (WIDTH,), "bias")]
    for b in range(depth):
        p = f"{t}.blocks.{b}"
        spec += [(f"{p}.norm1.weight", (WIDTH,), "norm"), (f"{p}.norm1.bias", (WIDTH,), "bias"),
                 (f"{p}.attn.qkv.weight", (3 * WIDTH, WIDTH), "fan_in"),
                 (f"{p}.attn.qkv.bias", (3 * WIDTH,), "bias"),
                 (f"{p}.attn.proj.weight", (WIDTH, WIDTH), "fan_in"),
                 (f"{p}.attn.proj.bias", (WIDTH,), "bias"),
                 (f"{p}.ls1.gamma", (WIDTH,), "gamma"),
                 (f"{p}.norm2.weight", (WIDTH,), "norm"), (f"{p}.norm2.bias", (WIDTH,), "bias"),
                 (f"{p}.mlp.fc1.weight", (MLP_WIDTH, WIDTH), "fan_in"),
                 (f"{p}.mlp.fc1.bias", (MLP_WIDTH,), "bias"),
                 (f"{p}.mlp.fc2.weight", (WIDTH, MLP_WIDTH), "fan_in"),
                 (f"{p}.mlp.fc2.bias", (WIDTH,), "bias"),
                 (f"{p}.ls2.gamma", (WIDTH,), "gamma")]
    return spec + [(f"{t}.norm.weight", (WIDTH,), "norm"), (f"{t}.norm.bias", (WIDTH,), "bias")]


def net_spec(stages: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of one net's PointNet++ and head (the tower
    apart), the initialisers of ``genpose_ref.param_spec``: the encoder over
    ``encoder_widths(stages, 384)``, the head as GenPose's."""
    spec = []
    for k, i, w in encoder_widths(stages, WIDTH):
        for j in range(len(w) - 1):
            p = f"encoder.sa_{k}.mlp_{i}"
            spec += [(f"{p}.dense_{j}.weight", (w[j + 1], w[j]), "lecun"),
                     (f"{p}.bn_{j}.weight", (w[j + 1],), "one"),
                     (f"{p}.bn_{j}.bias", (w[j + 1],), "zero"),
                     (f"{p}.bn_{j}.running_mean", (w[j + 1],), "mean0"),
                     (f"{p}.bn_{j}.running_var", (w[j + 1],), "var1")]
    return spec + [s for s in ref.param_spec(stages) if not s[0].startswith("encoder.")]


def tower_weights(spec, device, seed: int) -> Dict[str, torch.Tensor]:
    """The tower's weights from ``seed``, made on ``device`` in one draw:
    Linear and patch weights normal with std 1/sqrt(fan in), biases, the
    CLS token and ``pos_embed`` 0.02 N(0, 1), LayerNorm weights and
    LayerScale 1 + 0.1 N(0, 1) (near 1, not DINOv2's initial 1e-5, so that
    seeded blocks do real work)."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, init), n in zip(spec, sizes):
        x = base[at:at + n].reshape(shape)
        if init == "fan_in":
            w = x / math.sqrt(math.prod(shape[1:]))
        elif init in ("bias", "embed"):
            w = x * 0.02
        elif init in ("norm", "gamma"):
            w = 1.0 + x * 0.1
        else:
            raise ValueError(f"{name}: unknown initialiser {init!r}")
        out[name] = w.contiguous()
        at += n
    return out


def tower_depth(w: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in w if k.startswith(f"{TOWER}.blocks.") and k.endswith(".norm1.weight"))


# ---------------------------------------------------------------------------
# the tower and the lifting
# ---------------------------------------------------------------------------

def normalize(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> float32 [B, 3, S, S], ImageNet-normalised."""
    x = rgb.to(F32) / 255.0
    mean = torch.tensor(MEAN, dtype=F32, device=rgb.device)
    std = torch.tensor(STD, dtype=F32, device=rgb.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * weight + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU: x Phi(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def bilinear(grid: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """grid [B, C, s, s], crop pixels [B, N, 2] (u, v) -> [B, N, C]: patch
    i's centre at 14 i + 7, the coordinates clamped to the outermost centres."""
    B, C, s, _ = grid.shape
    x = torch.clamp(pix[..., 0] / PATCH - 0.5, 0.0, s - 1.0)
    y = torch.clamp(pix[..., 1] / PATCH - 0.5, 0.0, s - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.clamp(x0 + 1, max=s - 1), torch.clamp(y0 + 1, max=s - 1)
    flat = grid.reshape(B, C, s * s).transpose(1, 2)                 # [B, s*s, C]

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * s + xx)[..., None].expand(-1, -1, C))

    return ((1 - fy)[..., None] * ((1 - fx)[..., None] * at(y0, x0) + fx[..., None] * at(y0, x1))
            + fy[..., None] * ((1 - fx)[..., None] * at(y1, x0) + fx[..., None] * at(y1, x1)))


class DinoRef(ref.Ref):
    """GenPose with GenPose++'s image tower and wide stage 0 over one
    configuration; ``tf32`` as ``genpose_ref.Ref``'s."""

    def __init__(self, config: Dict, tf32: bool = False):
        if config.get("pts_encoder") != "dinov2_pointnet2":
            raise NotImplementedError("this reference computes pts_encoder='dinov2_pointnet2'")
        tower = config.get("image_tower", {})
        wrong = {k: tower.get(k) for k, v in TOWER_KEYS.items() if tower.get(k) != v}
        if wrong:
            raise NotImplementedError(f"this reference's tower is DINOv2 ViT-S/14; the "
                                      f"configuration gives {wrong}")
        super().__init__(config, tf32)

    # ----- the tower -----

    def tower(self, w: Dict, x: torch.Tensor) -> torch.Tensor:
        """Normalised crops [B, 3, S, S] -> the patch grid [B, 384, S/14, S/14]."""
        t = TOWER
        B, s = x.shape[0], x.shape[-1] // PATCH
        patches = (x.reshape(B, 3, s, PATCH, s, PATCH).permute(0, 2, 4, 1, 3, 5)
                   .reshape(B, s * s, 3 * PATCH * PATCH))
        h = (self.mm(patches, w[f"{t}.patch_embed.proj.weight"].reshape(WIDTH, -1).t())
             + w[f"{t}.patch_embed.proj.bias"])
        h = torch.cat([w[f"{t}.cls_token"].expand(B, 1, WIDTH), h], 1) + w[f"{t}.pos_embed"]
        T, dh = h.shape[1], WIDTH // HEADS
        for b in range(tower_depth(w)):
            p = f"{t}.blocks.{b}"
            y = layer_norm(h, w[f"{p}.norm1.weight"], w[f"{p}.norm1.bias"])
            qkv = self.dense(w, f"{p}.attn.qkv", y).reshape(B, T, 3, HEADS, dh)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))   # [B, heads, T, dh]
            logits = self.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            o = self.mm(e / e.sum(-1, keepdim=True), v).transpose(1, 2).reshape(B, T, WIDTH)
            h = h + w[f"{p}.ls1.gamma"] * self.dense(w, f"{p}.attn.proj", o)
            y = layer_norm(h, w[f"{p}.norm2.weight"], w[f"{p}.norm2.bias"])
            y = self.dense(w, f"{p}.mlp.fc2", gelu(self.dense(w, f"{p}.mlp.fc1", y)))
            h = h + w[f"{p}.ls2.gamma"] * y
        h = layer_norm(h, w[f"{t}.norm.weight"], w[f"{t}.norm.bias"])
        return h[:, 1:].transpose(1, 2).reshape(B, WIDTH, s, s)

    @torch.no_grad()
    def features(self, w: Dict, rgb: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
        """uint8 crops [B, S, S, 3] and crop pixels [B, N, 2] -> the lifted
        features [B, N, 384] (the frozen tower: no grad)."""
        return bilinear(self.tower(w, normalize(rgb)), pix.to(F32))

    # ----- the encoder over [xyz ; features] clouds -----

    def geometry(self, pts: torch.Tensor):
        return super().geometry(pts[..., :3])

    def encode(self, w: Dict, xyz: torch.Tensor, geo, train: bool = False,
               feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clouds [B, N, 3] (zero-mean) and their lifted features [B, N,
        384] -> features [B, 1024]; ``genpose_ref.Ref.encode`` with per-point
        input features."""
        for k, mlps in enumerate(self.stages["MLPS"]):
            if geo[k] is None:
                groups = [(xyz[:, None], feats[:, None])] * len(mlps)
            else:
                centers, idxs = geo[k]
                groups = [(ref.gather(xyz, gi) - centers[:, :, None, :], ref.gather(feats, gi))
                          for gi in idxs]
            outs = []
            for i, (gxyz, gfeat) in enumerate(groups):
                h = torch.cat([gxyz, gfeat], dim=-1)
                for j in range(len(mlps[i])):
                    p = f"encoder.sa_{k}.mlp_{i}"
                    h = self.dense(w, f"{p}.dense_{j}", h, bias=False)
                    h = torch.relu(self.batch_norm(w, f"{p}.bn_{j}", h, train))
                outs.append(torch.amax(h, dim=2))
            feats = torch.cat(outs, dim=-1)
            if geo[k] is not None:
                xyz = geo[k][0]
        return feats[:, 0, :]

    def dsm_loss(self, w: Dict, zm: torch.Tensor, gt: torch.Tensor, t: torch.Tensor,
                 z: torch.Tensor, geo) -> torch.Tensor:
        """``genpose_ref.Ref.dsm_loss`` over clouds [B, N, 3 + 384] whose
        channels after xyz are the lifted features."""
        R, B, _ = z.shape
        feat = self.encode(w, zm[..., :3], geo, train=True, feats=zm[..., 3:])
        proj = self.projection(w, feat).repeat(R, 1)
        std = ref.sigma(t)
        x = (gt[None] + z * std).reshape(R * B, 9)
        est = self.score(w, proj, x, t.reshape(R * B, 1)).reshape(R, B, 9)
        return torch.mean(torch.mean(torch.sum(std ** 2 * (est + z / std) ** 2, -1), -1))

    def train(self, w0: Dict, batches, noises, hp: Dict):
        """``genpose_ref.Ref.train`` over (clouds [B, N, 3 + 384] with their
        lifted features, gt poses), the tower's weights left out of ``w0``:
        they take no step."""
        net = {k: v for k, v in w0.items() if not k.startswith(f"{TOWER}.")}
        return super().train(net, batches, noises, hp)

    # ----- serving -----

    @torch.no_grad()
    def sample(self, w: Dict, pts: torch.Tensor, feats: torch.Tensor, z: torch.Tensor, K: int,
               steps: int, T0: float):
        """``genpose_ref.Ref.sample`` with the clouds' lifted features [B, N,
        384]: (hypotheses [B, K, 9], geometry, zero-mean clouds, centres)."""
        B = pts.shape[0]
        center = pts.mean(dim=1)
        zm = pts - center[:, None, :]
        geo = self.geometry(zm)
        x = z * (ref.SIGMA_MIN * (ref.SIGMA_MAX / ref.SIGMA_MIN) ** T0)
        proj = self.projection(w, self.encode(w, zm, geo, feats=feats)).repeat_interleave(K, 0)
        hyp = self.heun(w, proj, x, center.repeat_interleave(K, 0), steps, T0)
        return hyp.reshape(B, K, 9), geo, zm, center

    @torch.no_grad()
    def energies(self, w: Dict, zm: torch.Tensor, center: torch.Tensor, hyp: torch.Tensor,
                 feats: torch.Tensor, geo=None) -> torch.Tensor:
        """``genpose_ref.Ref.energies`` with the clouds' lifted features."""
        B, K, _ = hyp.shape
        geo = self.geometry(zm) if geo is None else geo
        proj = self.projection(w, self.encode(w, zm, geo, feats=feats)).repeat_interleave(K, 0)
        centred = torch.cat([hyp[..., :6], hyp[..., 6:] - center[:, None, :]], -1).reshape(B * K, 9)
        t = torch.full((B * K, 1), 1e-5, dtype=F32, device=hyp.device)
        return self.energy(w, proj, centred, t).reshape(B, K, 2)
