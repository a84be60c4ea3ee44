"""Traffic of kind ``train_rgb``: the score training loop of ``train.py``
with GenPose++'s image path.  Every object of the pool also has an RGB crop
(uint8 [crop, crop, 3], made from the seed on the host as a loader would
hand it over) and every point its crop pixel: the point projected with the
camera's intrinsics, into a square crop of ``pad`` times the larger side of
the points' projected box, centred on the box and resized to ``crop``
pixels (DZI without jitter), so every pixel lies inside its crop.  The 3D
augmentation moves the points and not their pixels.  Each step,
``process_batch`` takes the crops and pixels to the device, and
``PoseAgent.train_step`` runs the frozen image tower over them before
PointNet++ and leaves the lifted features in the batch, where the
monitoring loss of the same batch reads them: the tower runs once a step.

The check follows ``train.py``'s against ``reference/genpose_dino_ref.py``.
Per-layer metrics read the synchronised spans this driver puts around the
port's tower (``image_tower``) and PointNet++ stage 0's forward (``sa0``),
and the work of one call of each from ``SPAN_WORK``, which ``setup`` fills.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from harness import check, common, train, traffic as gen, work
from reference import genpose_dino_ref as dref

# (float32 operations, bytes) of one spanned call of the run's cell, by
# span name, for the per-layer readers in ``metrics/``
SPAN_WORK: Dict[str, Tuple[float, float]] = {}


# ---------------------------------------------------------------------------
# the crops, the weights and the work
# ---------------------------------------------------------------------------

def crop_pool(traffic: Dict, seed: int, pool, device):
    """Per pool batch {"rgb": uint8 [B, S, S, 3], "pix": float32 [B, N, 2]}
    (host arrays), from the batch's camera-frame clouds ``pcl_in``."""
    c = traffic["crop"]
    S, pad = c["size"], c["pad"]
    fx, fy, cx, cy = (c["intrinsics"][k] for k in ("fx", "fy", "cx", "cy"))
    gen_rgb = common.generator(device, common.seed_of(seed, 12))
    out = []
    for raw in pool:
        pts = torch.as_tensor(raw["pcl_in"], device=device)
        uv = torch.stack([fx * pts[..., 0] / pts[..., 2] + cx,
                          fy * pts[..., 1] / pts[..., 2] + cy], -1)          # [B, N, 2]
        lo, hi = uv.amin(1), uv.amax(1)
        side = pad * (hi - lo).amax(-1, keepdim=True)                         # [B, 1]
        corner = (lo + hi) / 2 - side / 2
        pix = (uv - corner[:, None]) * (S / side[:, None])
        rgb = torch.randint(0, 256, (pts.shape[0], S, S, 3), generator=gen_rgb, device=device,
                            dtype=torch.uint8)
        out.append({"rgb": rgb.cpu().numpy(), "pix": pix.to(torch.float32).cpu().numpy()})
    return out


def weights(config: Dict, device, seed: int) -> Dict[str, torch.Tensor]:
    """The score net's weights of a run: PointNet++ and the head as
    ``common.make_weights`` makes GenPose's, the tower from its own stream."""
    tower = config["image_tower"]
    return {**common.make_weights(dref.net_spec(config["encoder_stages"]), device,
                                  common.seed_of(seed, 0, 0)),
            **dref.tower_weights(dref.tower_spec(tower["num_layers"], tower["crop_px"]), device,
                                 common.seed_of(seed, 0, 2))}


def tower_ops(tower: Dict, crops: int) -> int:
    """Matrix-product operations of the tower over ``crops`` crops: the patch
    embedding, and per block qkv, q k^T, a v, proj, fc1 and fc2."""
    d, m, p = tower["embed_dim"], tower["mlp_dim"], tower["patch_size"]
    n = (tower["crop_px"] // p) ** 2
    T = n + 1
    block = 2 * T * d * (3 * d + d + 2 * m) + 2 * 2 * T * T * d
    return crops * (2 * n * 3 * p * p * d + tower["num_layers"] * block)


def encoder_ops(stages: Dict, n_points: int, in_features: int, backward: bool = False) -> int:
    """``work.encoder_ops`` with stage 0 grouping 3 + ``in_features`` channels."""
    total, n_in = 0, n_points
    widths = {(k, i): w for k, i, w in dref.encoder_widths(stages, in_features)}
    for k, npoint in enumerate(stages["NPOINTS"]):
        for i, ns in enumerate(stages["NSAMPLE"][k]):
            groups, samples = (1, n_in) if npoint is None else (npoint, ns)
            w = widths[(k, i)]
            for j in range(len(w) - 1):
                fwd = 2 * groups * samples * w[j] * w[j + 1]
                total += fwd
                if backward:
                    total += fwd if (k == 0 and j == 0) else 2 * fwd
        n_in = npoint or 1
    return total


def sa0_work(stages: Dict, batch: int, points: int, in_features: int) -> Tuple[int, int]:
    """(operations, bytes) that stage 0's forward over a batch cannot do
    without, whatever its gather.  Operations: each scale's first product
    split as W [dxyz ; f_j] = W_xyz dxyz + (W_f f)_j, the points' features
    projected once a point and dxyz once a neighbour, and the later products
    once a neighbour.  Bytes: the [B, N, 3 + C] input read once and the
    [B, npoint, sum of the scales' widths] output written once, float32."""
    npoint, ops = stages["NPOINTS"][0], 0
    for i, ns in enumerate(stages["NSAMPLE"][0]):
        w = stages["MLPS"][0][i]
        ops += 2 * batch * points * in_features * w[0]
        ops += 2 * batch * npoint * ns * 3 * w[0]
        ops += sum(2 * batch * npoint * ns * a * b for a, b in zip(w, w[1:]))
    width = sum(w[-1] for w in stages["MLPS"][0])
    return ops, 4 * batch * (points * (3 + in_features) + npoint * width)


def step_ops(config: Dict, traffic: Dict) -> int:
    """A step: the tower's forward, the wide encoder, the projection and the
    head forward and backward; and every ``ema_loss_every``-th step the
    monitoring loss's forward, which reads the step's lifted features."""
    stages, tower = config["encoder_stages"], config["image_tower"]
    B, R, N = traffic["batch"], traffic["repeat_num"], traffic["points"]
    C, rows = tower["embed_dim"], B * R
    fwd = B * encoder_ops(stages, N, C) + work.projection_ops(B) + work.head_ops(rows, rows)
    step = (tower_ops(tower, B) + B * encoder_ops(stages, N, C, backward=True)
            + work.projection_ops(B, backward=True) + work.head_ops(rows, rows, backward=True))
    return step + fwd / traffic["monitor"]["ema_loss_every"]


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class Driver(train.Driver):
    def weights(self):
        return weights(self.config, self.device, self.seed)

    def setup(self) -> None:
        tr, stages = self.traffic, self.config["encoder_stages"]
        C = self.config["image_tower"]["embed_dim"]
        SPAN_WORK.clear()
        SPAN_WORK["image_tower"] = (tower_ops(self.config["image_tower"], tr["batch"]), 0)
        SPAN_WORK["sa0"] = sa0_work(stages, tr["batch"], tr["points"], C)
        self.crops = crop_pool(tr, self.seed, gen.train_batches(tr, self.seed, self.device),
                               self.device)
        super().setup()

    def start(self) -> None:
        super().start()
        self.spans.wrap(self.agent.model.image_tower, "forward", "image_tower")
        self.spans.wrap(self.agent.model.encoder.sa_0, "forward", "sa0")

    def step(self, i: int) -> None:
        """``train.Driver.step`` with the batch's crops and pixels in the raw batch."""
        from genpose_tpu_torch.data.process import process_batch

        tr = self.traffic
        raw = {**self.pool[i % len(self.pool)], **self.crops[i % len(self.crops)]}
        draws = gen.augment_draws(self.aug_draws, tr, self.device)
        self.batch = process_batch(raw, self.config["pose_mode"],
                                   pts_aug_params=self.agent.cfg.pts_aug, device=self.device,
                                   draws=draws)
        noise = gen.dsm_draws(self.draws, tr["repeat_num"], tr["batch"], self.device)
        self.last = self.agent.train_step(self.batch, noise=noise)
        if self.kept_clouds is not None:
            self.kept_clouds.append(self.batch["zero_mean_pts"][..., :3])
        n = i + 1
        if n % tr["monitor"]["ema_loss_every"] == 0:
            self.monitor()
        if n % tr["monitor"]["loss_read_every"] == 0:
            float(self.last["gf"])

    def ops_per_unit(self) -> float:
        return step_ops(self.config, self.traffic)

    def check(self) -> dict:
        """``train.Driver.check`` against the reference with the image path:
        the lifted features of each checked step's crops ride as channels
        after xyz in the clouds the reference steps from."""
        w0, steps, noises, feats = inputs(self.config, self.traffic, self.device, self.seed)
        clouds = with_features(train.centred(self.prepared), feats)
        got = dref.DinoRef(self.config).train(w0, clouds, noises, train.hyper(self.traffic))
        return {**check.train_numbers(self.losses, self.first_grads, self.params, self.shadow,
                                      *got, w0),
                "aug_gap": check.aug_gap(self.prepared, train.prepare(self.traffic, steps))}


def inputs(config, traffic, device, seed, tf32: bool = False):
    """``train.inputs`` with this cell's weights, and the lifted features of
    each checked step's crops as the reference (``tf32``: in TF32) makes them."""
    _, steps, noises = train.inputs(config, traffic, device, seed)
    w0 = weights(config, device, seed)
    crops = crop_pool(traffic, seed, gen.train_batches(traffic, seed, device), device)
    r = dref.DinoRef(config, tf32=tf32)
    feats = []
    for i in range(traffic["checked_steps"]):
        c = crops[i % len(crops)]
        feats.append(r.features(w0, torch.as_tensor(c["rgb"], device=device),
                                torch.as_tensor(c["pix"], device=device)))
    return w0, steps, noises, feats


def with_features(centred, feats):
    """(zero-mean clouds, poses) -> ([clouds ; lifted features], poses)."""
    return [(torch.cat([zm, f], -1), gt) for (zm, gt), f in zip(centred, feats)]


def control(config, traffic, device, seed, n=None):
    """``train.control`` with the image path: the TF32 reference (its tower,
    augmentation and steps) against the float32 reference; the faults in
    the float32 reference: half of each batch, the augmentation skipped,
    and the lifted features zeroed (the tower skipped)."""
    hp = train.hyper(traffic)
    w0, steps, noises, feats = inputs(config, traffic, device, seed)
    _, _, _, feats_tf32 = inputs(config, traffic, device, seed, tf32=True)
    want_in = train.prepare(traffic, steps)
    ctl_in = train.prepare(traffic, steps, tf32=True)
    want = dref.DinoRef(config).train(w0, with_features(train.centred(ctl_in), feats), noises, hp)
    tf32 = dref.DinoRef(config, tf32=True).train(
        w0, with_features(train.centred(ctl_in), feats_tf32), noises, hp)
    out = {"control": {**check.train_numbers(*tf32, *want, w0),
                       "aug_gap": check.aug_gap(ctl_in, want_in)}}
    r = dref.DinoRef(config)
    clouds = with_features(train.centred(want_in), feats)
    want = r.train(w0, clouds, noises, hp)
    half = traffic["batch"] // 2
    got = r.train(w0, [(a[:half], b[:half]) for a, b in clouds],
                  [(t[:, :half], z[:, :half]) for t, z in noises], hp)
    out["half_batch"] = {**check.train_numbers(*got, *want, w0), "aug_gap": 0.0}
    got = r.train(w0, with_features(train.centred(want_in), [f * 0 for f in feats]), noises, hp)
    out["features_zeroed"] = {**check.train_numbers(*got, *want, w0), "aug_gap": 0.0}
    raw_in = [(raw["pcl_in"], torch.cat([raw["rotation"][..., 0], raw["rotation"][..., 1],
                                         raw["translation"]], -1)) for raw, _ in steps]
    out["aug_skipped"] = {"aug_gap": check.aug_gap(raw_in, want_in)}
    return out
