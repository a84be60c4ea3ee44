"""Training loops (counterpart of ``genpose_tpu/runners/trainer.py:82-212``).

- ``train_score``: score (or ranking-free energy) training with denoising
  score matching (reference ``trainer.py:266-322``), with an optional frozen
  teacher whose score replaces the DSM target (distillation,
  ``trainer.py:406-419``).  Every ``eval_freq`` epochs it samples one pose
  per object of the first train and val batch, logs the mean errors
  (``get_metrics``) and saves a checkpoint; a final checkpoint is always
  written.
- ``train_energy``: with ``ranking``, energy training where a frozen score
  agent generates K=5 candidates per batch online and the energy agent
  learns DSM plus the ranking of those candidates (``trainer.py:325-388``);
  the encoder geometry of the batch is computed once, by the sampling, and
  shared with the energy step.

A loader is any iterable of raw batches (dicts of numpy arrays as
``data/synthetic.py::synthetic_batch`` makes them).  Checkpoints go to
``<out_dir>/ckpts/<log_dir>``, metrics to ``<out_dir>/logs/<log_dir>/metrics.jsonl``.
Randomness comes from a ``torch.Generator`` on the agent's device seeded
with ``cfg.seed`` (``cfg.seed + 1`` for ``train_energy``, as in JAX).  The
CLI ``main()`` with the NOCS loaders, the eval visualisation and
multi-card training are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.eval.metrics import get_metrics
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import save_checkpoint
from genpose_tpu_torch.utils.logging import MetricsLogger, TrainClock

NUM_CANDIDATES = 5  # score-model candidates per object for the ranking loss (trainer.py:196)


def results_dirs(cfg: Config, out_dir: str = "results"):
    """(checkpoint directory, log directory) of a run."""
    return (os.path.join(out_dir, "ckpts", cfg.log_dir),
            os.path.join(out_dir, "logs", cfg.log_dir))


def _generator(agent: PoseAgent, seed: int) -> torch.Generator:
    return torch.Generator(device=agent.device).manual_seed(seed)


def _eval_epoch(cfg: Config, agent: PoseAgent, loaders, logger: MetricsLogger,
                epoch: int, generator: torch.Generator) -> None:
    """One sampled pose per object of the first batch of each loader, and
    its mean rotation / translation errors."""
    for loader, mode in loaders:
        raw = next(iter(loader), None)
        if raw is None:
            continue
        batch = process_batch(raw, cfg.pose_mode, mini_batch_size=cfg.mini_bs,
                              device=agent.device)
        pred = agent.sample(batch, generator=generator, repeat_num=1,
                            num_steps=cfg.sampling_steps)
        rot_err, trans_err = get_metrics(
            pred[:, 0].cpu().numpy(), batch["gt_pose"].cpu().numpy(),
            batch["id"].cpu().numpy(), cfg.synset_names,
            batch["handle_visibility"].cpu().numpy(), cfg.pose_mode, cfg.o2c_pose)
        logger.scalar(f"{mode}/ode_mean_rot_error", float(np.mean(rot_err)), epoch)
        logger.scalar(f"{mode}/ode_mean_trans_error", float(np.mean(trans_err)), epoch)


def train_score(cfg: Config, train_loader: Iterable, val_loader: Iterable, agent: PoseAgent,
                teacher: Optional[PoseAgent] = None, out_dir: str = "results") -> TrainClock:
    """Score (or ranking-free energy) training loop (ref ``trainer.py:266-322``)."""
    ckpt_dir, log_dir = results_dirs(cfg, out_dir)
    logger = MetricsLogger(log_dir)
    clock = agent.clock = getattr(agent, "clock", TrainClock())
    gen = _generator(agent, cfg.seed)
    last_saved = -1
    try:
        for _ in range(clock.epoch, cfg.n_epochs + 1):
            t_epoch = time.time()
            for raw in train_loader:
                batch = process_batch(raw, cfg.pose_mode, gen, cfg.pts_aug, device=agent.device)
                losses = (agent.train_step_distill(teacher, batch, gen) if teacher is not None
                          else agent.train_step(batch, gen))
                clock.tick()
                if clock.step % 50 == 0:
                    logger.scalars({k: float(v) for k, v in losses.items()}, clock.step,
                                   prefix="train/")
                if cfg.ema_rate > 0 and clock.step % 5 == 0:
                    logger.scalar("train/ema", float(agent.ema_loss(batch, gen)), clock.step)
            logger.scalar("epoch_time_s", time.time() - t_epoch, clock.epoch)
            clock.tock()
            if clock.epoch % cfg.eval_freq == 0:
                _eval_epoch(cfg, agent, ((train_loader, "train"), (val_loader, "val")),
                            logger, clock.epoch, gen)
                save_checkpoint(ckpt_dir, agent, clock.epoch, clock.make_checkpoint())
                last_saved = clock.epoch
        # always leave a final checkpoint, also when n_epochs < eval_freq
        if last_saved != clock.epoch:
            save_checkpoint(ckpt_dir, agent, clock.epoch, clock.make_checkpoint())
    finally:
        logger.close()
    return clock


def train_energy(cfg: Config, train_loader: Iterable, val_loader: Iterable,
                 energy_agent: PoseAgent, score_agent: Optional[PoseAgent] = None,
                 ranking: bool = False, out_dir: str = "results") -> TrainClock:
    """Energy training (ref ``trainer.py:325-388``).  Without ranking it is
    ``train_score`` with ``score_agent`` as the distillation teacher; with
    ranking, the frozen ``score_agent`` samples NUM_CANDIDATES poses per
    object online."""
    if not ranking:
        return train_score(cfg, train_loader, val_loader, energy_agent, teacher=score_agent,
                           out_dir=out_dir)
    if score_agent is None:
        raise ValueError("ranking needs a score agent to generate candidates")
    ckpt_dir, log_dir = results_dirs(cfg, out_dir)
    logger = MetricsLogger(log_dir)
    clock = energy_agent.clock = getattr(energy_agent, "clock", TrainClock())
    gen = _generator(energy_agent, cfg.seed + 1)
    last_saved = -1
    try:
        for _ in range(clock.epoch, cfg.n_epochs + 1):
            for raw in train_loader:
                batch = process_batch(raw, cfg.pose_mode, gen, cfg.pts_aug,
                                      device=energy_agent.device)
                # the candidates' sampling and the energy step encode the same
                # augmented points: one geometry pass (FPS + ball query) for both
                pose_samples, geom = score_agent.sample(
                    batch, generator=gen, repeat_num=NUM_CANDIDATES,
                    num_steps=cfg.sampling_steps, return_geometry=True)
                losses = energy_agent.train_step_energy(batch, pose_samples, gen, geometry=geom)
                clock.tick()
                if clock.step % 50 == 0:
                    logger.scalars({k: float(v) for k, v in losses.items()}, clock.step,
                                   prefix="train/")
            clock.tock()
            if clock.epoch % cfg.eval_freq == 0:
                save_checkpoint(ckpt_dir, energy_agent, clock.epoch, clock.make_checkpoint())
                last_saved = clock.epoch
        if last_saved != clock.epoch:
            save_checkpoint(ckpt_dir, energy_agent, clock.epoch, clock.make_checkpoint())
    finally:
        logger.close()
    return clock
