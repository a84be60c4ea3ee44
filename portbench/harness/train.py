"""Traffic of kind ``train``: the score net's training loop, one step after
the other, as ``runners/trainer.py::train_score`` runs it: a raw batch from
a pool made in set-up (host arrays, as the NOCS loader hands them over)
goes through ``data/process.py::process_batch`` with the 3D augmentation
(``pts_aug``, its draws from the seed), then ``PoseAgent.train_step``: the
DSM loss over ``repeat_num`` draws, clip, Adam and the EMA.  Every
``ema_loss_every``-th step the trainer's monitoring loss under the EMA
weights is read on the host, and every ``loss_read_every``-th step the
step's loss.  Set-up builds the agent and drives it through its first
``checked_steps`` steps, which the check follows (from the clouds and poses
the program's augmentation made, whose own check is ``aug_gap``); the
window continues the same agent.  End to end: ``train_samples_per_s``, every sample of the
window's steps over the window's time, the device synchronised at its
end."""

from __future__ import annotations

import torch

from harness import check, common, traffic as gen, work
from reference import genpose_ref as ref


def hyper(traffic) -> dict:
    return {k: traffic[k] for k in ("lr", "warmup", "lr_decay", "lr_floor", "steps_per_epoch",
                                    "grad_clip", "ema")}


class Driver:
    def __init__(self, config, traffic, device, seed, spans):
        self.config, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.spans = spans
        self.kept_clouds = None   # the zero-mean clouds of the profiled steps

    def weights(self):
        spec = ref.param_spec(self.config["encoder_stages"])
        return common.make_weights(spec, self.device, common.seed_of(self.seed, 0, 0))

    def setup(self) -> None:
        from genpose_tpu_torch.config import PtsAugConfig
        from genpose_tpu_torch.training.agent import PoseAgent

        tr = self.traffic
        cfg = common.port_config(self.config, batch_size=tr["batch"], mini_bs=tr["batch"],
                                 repeat_num=tr["repeat_num"], lr=tr["lr"], warmup=tr["warmup"],
                                 lr_decay=tr["lr_decay"], lr_floor=tr["lr_floor"],
                                 grad_clip=tr["grad_clip"], ema_rate=tr["ema"],
                                 optimizer=tr["optimizer"], pts_aug=PtsAugConfig(**tr["pts_aug"]))
        self.agent = PoseAgent(cfg, "score", device=self.device,
                               steps_per_epoch=tr["steps_per_epoch"])
        common.load_weights(self.agent, self.weights())
        self.pool = gen.train_batches(tr, self.seed, self.device)
        self.draws, self.aug_draws = draw_streams(self.seed, self.device)
        self.losses, self.prepared = [], []
        for i in range(tr["checked_steps"]):
            self.step(i)
            self.losses.append(self.last["gf"])
            self.prepared.append((self.batch["pts"][..., :3].clone(),
                                  self.batch["gt_pose"].clone()))
            if i == 0:
                mu = self.agent.state.opt_state["mu"]
                self.first_grads = {k: v / (1 - 0.9) for k, v in mu.items()}
        self.params = {k: p.detach().clone() for k, p in self.agent.params().items()}
        self.shadow = {k: v.clone() for k, v in self.agent.state.ema.shadow.items()}
        self.first = tr["checked_steps"]

    def warm(self, i: int) -> None:
        """A step before the window, after the checked ones, and the
        monitoring loss, whose shapes the window meets every few steps."""
        self.step(self.first)
        self.monitor()
        self.first += 1

    def start(self) -> None:
        self.spans.wrap(self.agent.state, "apply_gradients", "optimizer")

    def step(self, i: int) -> None:
        """Step i: the trainer's batch preparation, its step, and its reads
        of the monitoring loss and the step's loss."""
        from genpose_tpu_torch.data.process import process_batch

        tr = self.traffic
        raw = self.pool[i % len(self.pool)]
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

    def monitor(self) -> None:
        noise = gen.dsm_draws(self.draws, self.traffic["repeat_num"], self.traffic["batch"],
                              self.device)
        float(self.agent.ema_loss(self.batch, noise=noise))
        if self.kept_clouds is not None:     # its geometry runs again on the step's clouds
            self.kept_clouds.append(self.batch["zero_mean_pts"][..., :3])

    def unit(self, i: int):
        with self.spans.span("step"):
            self.step(self.first + i)
        return None

    def end_to_end(self, units: int, window_s: float, latencies) -> dict:
        return {"train_samples_per_s": units * self.traffic["batch"] / window_s}

    def ops_per_unit(self) -> float:
        """A step's products, and the monitoring loss's forward every
        ``ema_loss_every``-th step."""
        tr = self.traffic
        shape = (self.config["encoder_stages"], tr["batch"], tr["repeat_num"], tr["points"])
        return (work.train_ops(*shape)
                + work.dsm_forward_ops(*shape) / tr["monitor"]["ema_loss_every"])

    def profiled(self, first: int, n: int) -> None:
        self.kept_clouds = []
        for i in range(first, first + n):
            self.step(self.first + i)

    def geometry_clouds(self):
        yield from self.kept_clouds

    def close(self, units: int) -> None:
        self.losses = [float(v) for v in self.losses]
        del self.agent, self.batch, self.last

    def check(self) -> dict:
        """The reference's steps from the program's augmented clouds and
        poses, centred by the reference; the augmentation itself against
        the reference's own (``aug_gap``)."""
        w0, steps, noises = inputs(self.config, self.traffic, self.device, self.seed)
        got = ref.Ref(self.config).train(w0, centred(self.prepared), noises, hyper(self.traffic))
        return {**check.train_numbers(self.losses, self.first_grads, self.params, self.shadow,
                                      *got, w0),
                "aug_gap": check.aug_gap(self.prepared, prepare(self.traffic, steps))}


def draw_streams(seed: int, device):
    """The generators of a run's DSM draws and of its augmentation draws."""
    return (common.generator(device, common.seed_of(seed, 10)),
            common.generator(device, common.seed_of(seed, 11)))


def inputs(config, traffic, device, seed):
    """What a run's first ``checked_steps`` steps are fed, made again from
    the seed: the weights, (each step's raw batch on the device, its
    augmentation draws), and the DSM draws."""
    spec = ref.param_spec(config["encoder_stages"])
    w0 = common.make_weights(spec, device, common.seed_of(seed, 0, 0))
    pool = gen.train_batches(traffic, seed, device)
    draws, aug_draws = draw_streams(seed, device)
    steps, noises = [], []
    for i in range(traffic["checked_steps"]):
        raw = {k: torch.as_tensor(v, device=device) for k, v in pool[i % len(pool)].items()}
        steps.append((raw, gen.augment_draws(aug_draws, traffic, device)))
        noises.append(gen.dsm_draws(draws, traffic["repeat_num"], traffic["batch"], device))
    return w0, steps, noises


def prepare(traffic, steps, tf32: bool = False):
    """The reference's augmentation of each step: (clouds, gt poses as the
    rotation's first two columns and the translation)."""
    out = []
    for raw, d in steps:
        pts, R, t = ref.augment(traffic["pts_aug"], raw, d, tf32)
        out.append((pts, torch.cat([R[..., 0], R[..., 1], t], -1)))
    return out


def centred(prepared):
    """(zero-mean clouds, zero-mean gt poses) of augmented clouds and poses."""
    out = []
    for pts, pose in prepared:
        c = pts.mean(1)
        out.append((pts - c[:, None], torch.cat([pose[:, :6], pose[:, 6:] - c], -1)))
    return out


def control(config, traffic, device, seed, n=None):
    """The TF32 reference in the program's place (its augmentation and its
    steps) against the float32 reference, which, as in the check, steps
    from the clouds and poses that augmentation made; and the faults in the
    float32 reference: the first half of each batch and of its draws (the
    mean taken over the rest), and the augmentation skipped."""
    hp = hyper(traffic)
    w0, steps, noises = inputs(config, traffic, device, seed)
    want_in = prepare(traffic, steps)
    ctl_in = prepare(traffic, steps, tf32=True)
    want = ref.Ref(config).train(w0, centred(ctl_in), noises, hp)
    tf32 = ref.Ref(config, tf32=True).train(w0, centred(ctl_in), noises, hp)
    out = {"control": {**check.train_numbers(*tf32, *want, w0),
                       "aug_gap": check.aug_gap(ctl_in, want_in)}}
    want = ref.Ref(config).train(w0, centred(want_in), noises, hp)
    half = traffic["batch"] // 2
    got = ref.Ref(config).train(w0, [(a[:half], b[:half]) for a, b in centred(want_in)],
                                [(t[:, :half], z[:, :half]) for t, z in noises], hp)
    out["half_batch"] = {**check.train_numbers(*got, *want, w0), "aug_gap": 0.0}
    raw_in = [(raw["pcl_in"], torch.cat([raw["rotation"][..., 0], raw["rotation"][..., 1],
                                         raw["translation"]], -1)) for raw, _ in steps]
    out["aug_skipped"] = {"aug_gap": check.aug_gap(raw_in, want_in)}
    return out
