"""GenPose in plain PyTorch: the benchmark's frozen reference.

Written from the published model (Zhang et al., "GenPose: Generative
Category-level Object Pose Estimation via Diffusion Models", NeurIPS 2023,
and its released code: ``networks/pts_encoder/pointnet2.py``,
``networks/gf_algorithms/{scorenet,energynet,sde,samplers,losses}.py``,
``networks/reward.py``, ``utils/misc.py``), not from the program under test:
it imports nothing of ``genpose_tpu_torch`` or ``genpose_tpu``.  Every
tensor is float32; every matrix product goes through ``Ref.mm``, which
runs with TF32 off or, for the control, on operands rounded to TF32's 10
mantissa bits (``to_tf32``).

Parameters are one flat dict per net, named as the port's ``state_dict``
names them (``encoder.sa_0.mlp_0.dense_0.weight``, ``head.trunk.tails.
feat_kernel``...), so that the benchmark can load the same numbers into
both sides; ``param_spec`` lists those names with shapes and the
initialiser of each, from the configuration's widths alone.

What is here: farthest point sampling and ball query as loops and masks;
the PointNet++ MSG classification encoder over the configuration's stages
(BatchNorm on running statistics in evaluation, on batch statistics in
training); the score and IP energy heads with three fused tails
(``Rx_Ry_and_T``); the VE SDE; the fixed-step Heun PF-ODE sampler with its
denoising step; the decoupled energy sort and the quaternion pooling; the
denoising score-matching loss over ``repeat_num`` draws, after FS-Net's
batched 3D augmentation (``utils/data_augmentation.py``); clip by global
norm, Adam and the EMA shadow as the optax chain computes them (the
schedule read before the step count increments).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32
POSE_DIM = 9          # rot_matrix: the first two columns of R, then t
TAIL_HIDDEN = 256     # each of the three fused tails (Rx, Ry, T)
FEAT_DIM = 1024
T_DIM = 128
POSE_FEAT = 256
BN_EPS = 1e-5
SIGMA_MIN, SIGMA_MAX, SDE_EPS = 0.01, 50.0, 1e-5


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(F32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        ga = g @ to_tf32(b).transpose(-1, -2)
        gb = to_tf32(a).transpose(-1, -2) @ g
        return ga, gb


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def encoder_widths(stages: Dict) -> List[Tuple[int, int, List[int]]]:
    """(stage, scale, [in, w1, w2, ...]) for every SharedMLP of the encoder."""
    out, c = [], 0
    for k, mlps in enumerate(stages["MLPS"]):
        for i, mlp in enumerate(mlps):
            out.append((k, i, [c + 3, *mlp]))
        c = sum(m[-1] for m in mlps)
    if c != FEAT_DIM:
        raise ValueError(f"the encoder ends in {c} channels, the heads take {FEAT_DIM}")
    return out


def param_spec(stages: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of one net (score or energy: the same layout).
    init: ``lecun`` (normal, std 1/sqrt(fan in)), ``tail`` (normal, std
    1/sqrt(1408), the tails' concatenated fan in), ``one``, ``zero``,
    ``fourier`` (normal x 30), and the BatchNorm statistics ``mean0`` /
    ``var1``.  Names ending in ``running_mean`` / ``running_var`` and the
    Fourier ``W`` are buffers; the rest are trained."""
    spec = []
    for k, i, w in encoder_widths(stages):
        for j in range(len(w) - 1):
            p = f"encoder.sa_{k}.mlp_{i}"
            spec += [(f"{p}.dense_{j}.weight", (w[j + 1], w[j]), "lecun"),
                     (f"{p}.bn_{j}.weight", (w[j + 1],), "one"),
                     (f"{p}.bn_{j}.bias", (w[j + 1],), "zero"),
                     (f"{p}.bn_{j}.running_mean", (w[j + 1],), "mean0"),
                     (f"{p}.bn_{j}.running_var", (w[j + 1],), "var1")]
    h = "head.trunk"
    kh = 3 * TAIL_HIDDEN
    spec += [(f"{h}.t_fourier.W", (T_DIM // 2,), "fourier"),
             (f"{h}.t_dense.weight", (T_DIM, T_DIM), "lecun"),
             (f"{h}.t_dense.bias", (T_DIM,), "zero"),
             (f"{h}.pose_dense_0.weight", (POSE_FEAT, POSE_DIM), "lecun"),
             (f"{h}.pose_dense_0.bias", (POSE_FEAT,), "zero"),
             (f"{h}.pose_dense_1.weight", (POSE_FEAT, POSE_FEAT), "lecun"),
             (f"{h}.pose_dense_1.bias", (POSE_FEAT,), "zero"),
             (f"{h}.tails.feat_kernel", (FEAT_DIM, kh), "tail"),
             (f"{h}.tails.t_kernel", (T_DIM, kh), "tail"),
             (f"{h}.tails.pose_kernel", (POSE_FEAT, kh), "tail"),
             (f"{h}.tails.bias", (kh,), "zero"),
             (f"{h}.tails.out_kernel", (3, TAIL_HIDDEN, 3), "zero"),
             (f"{h}.tails.out_bias", (3, 3), "zero")]
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith((".running_mean", ".running_var", ".W"))


# ---------------------------------------------------------------------------
# SDE, geometry and pose math
# ---------------------------------------------------------------------------

def sigma(t: torch.Tensor) -> torch.Tensor:
    """VE marginal std at time t."""
    return SIGMA_MIN * (SIGMA_MAX / SIGMA_MIN) ** t


# g(t) = sigma(t) * sqrt(2 (log smax - log smin)), the constant in float32
G_CONST = float(np.sqrt(np.float32(2.0) * (np.log(np.float32(SIGMA_MAX))
                                           - np.log(np.float32(SIGMA_MIN)))))


def time_grid(start: float, stop: float, num: int, device) -> torch.Tensor:
    """num float32 times from start to stop: start (1 - s) + stop s, s = i / (num - 1)."""
    start_t = torch.tensor(start, dtype=F32, device=device)
    stop_t = torch.tensor(stop, dtype=F32, device=device)
    s = torch.arange(num - 1, dtype=F32, device=device) / torch.tensor(num - 1, dtype=F32)
    return torch.cat([start_t * (1 - s) + stop_t * s, stop_t[None]])


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest point sampling from index 0; ties go to the lowest index."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=F32, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = [last]
    for _ in range(npoint - 1):
        mind = torch.minimum(mind, sq_dist(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=1)
        out.append(last)
    return torch.stack(out, dim=1)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               centers: torch.Tensor) -> torch.Tensor:
    """The first ``nsample`` point indices, in index order, with d^2 < r^2
    (r^2 rounded once from the double square), padded with the first hit;
    zeros where the ball is empty."""
    r2 = float(np.float32(float(radius) * float(radius)))
    n = xyz.shape[1]
    out = []
    for lo in range(0, xyz.shape[0], 32):
        d2 = sq_dist(centers[lo:lo + 32, :, None, :], xyz[lo:lo + 32, None, :, :])
        cand = torch.where(d2 < r2, torch.arange(n, device=xyz.device, dtype=torch.int32),
                           torch.tensor(n, device=xyz.device, dtype=torch.int32))
        first = torch.topk(cand, nsample, dim=-1, largest=False, sorted=True).values
        pad = torch.where(first[..., :1] < n, first[..., :1], 0)
        out.append(torch.where(first < n, first, pad).long())
    return torch.cat(out)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] -> [B, ..., C]."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1)
    g = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return g.reshape(*idx.shape, points.shape[-1])


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """The first two columns of R, Gram-Schmidt, then their cross product."""
    a1, a2 = d6[..., :3], d6[..., 3:6]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True), min=1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), from the largest of
    the four |q_i| (the pytorch3d construction)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1), min=0.0))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2) / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_moment(quats: torch.Tensor) -> torch.Tensor:
    """The mean outer product of quaternions [B, K, 4], each with w >= 0:
    its top eigenvector is the average rotation."""
    q = torch.where(quats[..., :1] > 0, 1.0, -1.0) * quats
    return torch.einsum("bki,bkj->bij", q, q) / q.shape[1]


def lr_at(step: int, base: float, warmup: int, decay: float, per_epoch: int,
          floor: float) -> float:
    """The learning rate read at update count ``step`` (before the increment)."""
    f = np.float32
    floor_epochs = (0 if decay == 1.0 else
                    max(0, math.ceil(math.log(floor / base) / math.log(decay))))
    warm = np.minimum(f(step) / f(max(warmup, 1)), f(1.0))
    n_decay = np.minimum(np.floor(f(step) / f(per_epoch)), f(floor_epochs))
    return float(f(base) * warm * f(decay) ** n_decay)


def rotate(R: torch.Tensor, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """R [B, 3, 3] applied to points x [B, N, 3], as elementwise sums
    (``tf32``: of operands rounded to TF32)."""
    if tf32:
        R, x = to_tf32(R), to_tf32(x)
    return (R[:, None] * x[:, :, None, :]).sum(-1)


def augment(p: Dict, b: Dict[str, torch.Tensor], d: Dict[str, torch.Tensor],
            tf32: bool = False):
    """FS-Net's batched 3D augmentation as the score trainer applies it
    (upstream ``utils/data_augmentation.py:71-305``): each of four changes
    made for the whole batch and kept per object where its uniform
    ``d[flag]`` is under its probability in ``p``, in this order: the box
    scaled in the object frame (symmetric categories share the x and z
    factor), a rigid turn and shift, a box cage along y for bowls (id 1)
    and mugs (id 5), a jitter of each point away from the centre.  ``b``:
    the raw batch on the device; ``d``: the step's draws; ``tf32``: every
    rotation's operands rounded to TF32.  Returns the clouds, rotations and
    translations."""

    def rot(R, x):
        return rotate(R, x, tf32)

    pc, R, t = b["pcl_in"], b["rotation"], b["translation"]
    Rt = R.transpose(1, 2)
    size = b["fsnet_scale"] + b["mean_shape"]
    model = b["model_point"]
    # the box scaled in the object frame
    keep = (d["bb"] < p["aug_bb_pro"])[..., None]
    bb = b["aug_bb"]
    bb = torch.where(b["sym_info"][:, :1] == 1, (bb + bb[:, [2, 1, 0]]) / 2, bb)
    scaled = rot(R, rot(Rt, pc - t[:, None]) * bb[:, None]) + t[:, None]
    pc = torch.where(keep, scaled, pc)
    size = torch.where(keep[:, 0], size * bb, size)
    model = torch.where(keep, model * bb[:, None], model)
    # a rigid turn and shift
    keep = (d["rt"] < p["aug_rt_pro"])[..., None]
    Ra, ta = b["aug_rt_R"], b["aug_rt_t"]
    pc = torch.where(keep, rot(Ra, pc + ta[:, None]), pc)
    R = torch.where(keep, rot(Ra, R.transpose(1, 2)).transpose(1, 2), R)
    t = torch.where(keep[:, 0], rot(Ra, (t + ta)[:, None])[:, 0], t)
    # the box cage along y, bowls and mugs only
    cat = b["cat_id"].reshape(-1)
    keep = ((d["bc"] < p["aug_bc_pro"]) & ((cat == 1) | (cat == 5))[:, None])[..., None]
    local = rot(R.transpose(1, 2), pc - t[:, None])
    sy = size[:, None, 1]
    k = (local[..., 1] + sy / 2) / sy * (d["ey_up"] - d["ey_down"]) + d["ey_down"]
    caged = torch.stack([local[..., 0] * k, local[..., 1], local[..., 2] * k], -1)
    pc = torch.where(keep, rot(R, caged) + t[:, None], pc)
    # each point moved away from the centre
    keep = (d["pc"] < p["aug_pc_pro"])[..., None]
    pc = torch.where(keep, pc + d["jitter"] * p["aug_pc_r"] * (pc - t[:, None]), pc)
    return pc, R, t


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------

class Ref:
    """GenPose over one configuration.  ``tf32`` rounds the operands of
    every matrix product (forward and backward) to TF32: the control."""

    def __init__(self, config: Dict, tf32: bool = False):
        self.stages = config["encoder_stages"]
        if config["regression_head"] != "Rx_Ry_and_T" or config["pose_mode"] != "rot_matrix":
            raise NotImplementedError("the reference has the Rx_Ry_and_T head over rot_matrix")
        if config["sde_mode"] != "ve" or config["energy_mode"] != "IP":
            raise NotImplementedError("the reference has the VE SDE and the IP energy")
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return a @ b

    def dense(self, w: Dict, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        y = self.mm(x, w[name + ".weight"].t())
        return y + w[name + ".bias"] if bias else y

    # ----- encoder -----

    def geometry(self, xyz: torch.Tensor) -> List[Optional[Tuple[torch.Tensor, list]]]:
        """Per SA stage (centres, [ball indices per radius]); None for the
        stage that groups all points."""
        geo = []
        for npoint, radii, nsamples in zip(self.stages["NPOINTS"], self.stages["RADIUS"],
                                           self.stages["NSAMPLE"]):
            if npoint is None:
                geo.append(None)
                continue
            centers = gather(xyz, fps(xyz, npoint))
            geo.append((centers, [ball_query(r, s, xyz, centers)
                                  for r, s in zip(radii, nsamples)]))
            xyz = centers
        return geo

    def batch_norm(self, w: Dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            rows = x.reshape(-1, x.shape[-1])
            mean = rows.mean(0)
            var = ((rows - mean) ** 2).mean(0)
        else:
            mean, var = w[name + ".running_mean"], w[name + ".running_var"]
        return (x - mean) / torch.sqrt(var + BN_EPS) * w[name + ".weight"] + w[name + ".bias"]

    def encode(self, w: Dict, xyz: torch.Tensor, geo, train: bool = False) -> torch.Tensor:
        """Clouds [B, N, 3] (zero-mean) -> features [B, 1024]."""
        feats = None
        for k, mlps in enumerate(self.stages["MLPS"]):
            if geo[k] is None:
                groups = [(xyz[:, None], None if feats is None else feats[:, None])] * len(mlps)
            else:
                centers, idxs = geo[k]
                groups = [(gather(xyz, gi) - centers[:, :, None, :],
                           None if feats is None else gather(feats, gi)) for gi in idxs]
            outs = []
            for i, (gxyz, gfeat) in enumerate(groups):
                h = gxyz if gfeat is None else torch.cat([gxyz, gfeat], dim=-1)
                for j in range(len(mlps[i])):
                    p = f"encoder.sa_{k}.mlp_{i}"
                    h = self.dense(w, f"{p}.dense_{j}", h, bias=False)
                    h = torch.relu(self.batch_norm(w, f"{p}.bn_{j}", h, train))
                outs.append(torch.amax(h, dim=2))
            feats = torch.cat(outs, dim=-1)
            if geo[k] is not None:
                xyz = geo[k][0]
        return feats[:, 0, :]

    # ----- heads -----

    def projection(self, w: Dict, feat: torch.Tensor) -> torch.Tensor:
        """The tails' loop-invariant part: feature [B, 1024] -> [B, 768]."""
        return self.mm(feat, w["head.trunk.tails.feat_kernel"])

    def f_theta(self, w: Dict, proj: torch.Tensor, pose: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """The trunk and the three tails: proj [n, 768], pose [n, 9], t [n or 1, 1] -> [n, 9]."""
        h = "head.trunk"
        x = t[:, 0][:, None] * w[f"{h}.t_fourier.W"][None, :] * 2 * math.pi
        fourier = torch.cat([torch.sin(x), torch.cos(x)], -1)
        t_feat = torch.relu(self.dense(w, f"{h}.t_dense", fourier))
        p = torch.relu(self.dense(w, f"{h}.pose_dense_0", pose))
        p = torch.relu(self.dense(w, f"{h}.pose_dense_1", p))
        z = (proj + self.mm(t_feat, w[f"{h}.tails.t_kernel"])
             + self.mm(p, w[f"{h}.tails.pose_kernel"]) + w[f"{h}.tails.bias"])
        z = torch.relu(z).reshape(z.shape[0], 3, TAIL_HIDDEN).transpose(0, 1)   # [3, n, 256]
        out = self.mm(z, w[f"{h}.tails.out_kernel"]) + w[f"{h}.tails.out_bias"][:, None, :]
        return out.transpose(0, 1).reshape(z.shape[1], 9)

    def score(self, w, proj, pose, t) -> torch.Tensor:
        return self.f_theta(w, proj, pose, t) / (sigma(t) + 1e-7)

    def energy(self, w, proj, pose, t) -> torch.Tensor:
        """Decoupled IP energies [n, 2] (rotation, translation)."""
        s = self.f_theta(w, proj, pose, t) / sigma(t)
        return torch.stack([torch.sum(pose[:, :-3] * s[:, :-3], -1),
                            torch.sum(pose[:, -3:] * s[:, -3:], -1)], dim=-1)

    # ----- serving -----

    @torch.no_grad()
    def heun(self, w: Dict, proj: torch.Tensor, x: torch.Tensor, center: torch.Tensor,
             steps: int, T0: float) -> torch.Tensor:
        """The PF-ODE from x at T0 to eps in ``steps - 1`` Heun steps, the
        denoising step, the rotation re-projected, the centre added."""
        ts = time_grid(T0, SDE_EPS, steps, x.device)

        def dx(x, t):
            t = t.reshape(1, 1)
            return -0.5 * (sigma(t) * G_CONST) ** 2 * self.score(w, proj, x, t)

        for i in range(steps - 1):
            dt = ts[i + 1] - ts[i]
            k1 = dx(x, ts[i])
            k2 = dx(x + dt * k1, ts[i + 1])
            x = x + dt * 0.5 * (k1 + k2)
        eps = torch.tensor(SDE_EPS, dtype=F32, device=x.device).reshape(1, 1)
        step = (1.0 - SDE_EPS) / steps
        x = x + (sigma(eps) * G_CONST) ** 2 * self.score(w, proj, x, eps) * step
        rot = rot6d_to_matrix(x[:, :6])
        return torch.cat([rot[..., 0], rot[..., 1], x[:, 6:] + center], dim=-1)

    @torch.no_grad()
    def sample(self, w: Dict, pts: torch.Tensor, z: torch.Tensor, K: int, steps: int,
               T0: float, init: Optional[torch.Tensor] = None):
        """Clouds [B, N, 3] (camera frame) and the prior's unit draws z
        [B * K, 9], optionally around starts ``init`` [B, 9] (zero-mean
        frame) -> (hypotheses [B, K, 9] in the camera frame, and the
        geometry, zero-mean clouds and centres used on the way)."""
        B = pts.shape[0]
        center = pts.mean(dim=1)
        zm = pts - center[:, None, :]
        geo = self.geometry(zm)
        x = z * (SIGMA_MIN * (SIGMA_MAX / SIGMA_MIN) ** T0)
        if init is not None:
            x = init.repeat_interleave(K, dim=0) + x
        proj = self.projection(w, self.encode(w, zm, geo)).repeat_interleave(K, 0)
        hyp = self.heun(w, proj, x, center.repeat_interleave(K, 0), steps, T0)
        return hyp.reshape(B, K, 9), geo, zm, center

    @torch.no_grad()
    def energies(self, w: Dict, zm: torch.Tensor, center: torch.Tensor, hyp: torch.Tensor,
                 geo=None) -> torch.Tensor:
        """Energies [B, K, 2] of camera-frame hypotheses [B, K, 9] at t = 1e-5."""
        B, K, _ = hyp.shape
        geo = self.geometry(zm) if geo is None else geo
        proj = self.projection(w, self.encode(w, zm, geo)).repeat_interleave(K, 0)
        centred = torch.cat([hyp[..., :6], hyp[..., 6:] - center[:, None, :]], -1).reshape(B * K, 9)
        t = torch.full((B * K, 1), 1e-5, dtype=F32, device=hyp.device)
        return self.energy(w, proj, centred, t).reshape(B, K, 2)

    # ----- training -----

    def dsm_loss(self, w: Dict, zm: torch.Tensor, gt: torch.Tensor, t: torch.Tensor,
                 z: torch.Tensor, geo) -> torch.Tensor:
        """DSM over R draws: t [R, B, 1], z [R, B, 9]; gt [B, 9] zero-mean."""
        R, B, _ = z.shape
        proj = self.projection(w, self.encode(w, zm, geo, train=True)).repeat(R, 1)
        std = sigma(t)
        x = (gt[None] + z * std).reshape(R * B, 9)
        est = self.score(w, proj, x, t.reshape(R * B, 1)).reshape(R, B, 9)
        return torch.mean(torch.mean(torch.sum(std ** 2 * (est + z / std) ** 2, -1), -1))

    def train(self, w0: Dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              noises: Sequence[Tuple[torch.Tensor, torch.Tensor]], hp: Dict):
        """Steps of DSM + clip + Adam + EMA from weights ``w0`` over
        (zero-mean clouds, zero-mean gt poses) and (t, z) draws.  Returns
        (losses, the first step's clipped gradients, the parameters and the
        EMA shadow after the last step), the last three as dicts of the
        trained names."""
        names = [k for k in w0 if not is_buffer(k)]
        params = {k: w0[k].clone() for k in names}
        shadow = {k: v.clone() for k, v in params.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        losses, first_grads = [], None
        for step, ((zm, gt), (t, z)) in enumerate(zip(batches, noises)):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            w = {**w0, **leaves}
            with torch.no_grad():
                geo = self.geometry(zm)
            loss = self.dsm_loss(w, zm, gt, t, z, geo)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = dict(zip(names, grads))
                norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
                if float(norm) >= hp["grad_clip"]:
                    g = {k: v / norm * hp["grad_clip"] for k, v in g.items()}
                if first_grads is None:
                    first_grads = {k: v.clone() for k, v in g.items()}
                lr = lr_at(step, hp["lr"], hp["warmup"], hp["lr_decay"], hp["steps_per_epoch"],
                           hp["lr_floor"])
                count = step + 1
                c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
                c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
                decay = np.minimum(np.float32(hp["ema"]), (np.float32(1.0) + np.float32(count))
                                   / (np.float32(10.0) + np.float32(count)))
                rate = float(np.float32(1.0) - decay)
                for k in names:
                    mu[k] = (1 - b1) * g[k] + b1 * mu[k]
                    nu[k] = (1 - b2) * g[k] * g[k] + b2 * nu[k]
                    params[k] = params[k] - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
                    shadow[k] = shadow[k] - (shadow[k] - params[k]) * rate
        return losses, first_grads, params, shadow
