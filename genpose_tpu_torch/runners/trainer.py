"""Training and inference CLI (counterpart of ``genpose_tpu/runners/trainer.py``).

Usage (the same flags and defaults as ``python -m genpose_tpu.runners.trainer``;
``--device cpu`` runs on the CPU, any other value on the card):

    python -m genpose_tpu_torch.runners.trainer --agent_type score --data_path <nocs> \
        --is_train true
    python -m genpose_tpu_torch.runners.trainer --agent_type energy_with_ranking \
        --pretrained_score_model_path <ckpt> --sampler_mode ode_adaptive --data_path <nocs>
    python -m genpose_tpu_torch.runners.trainer --eval true --model_name <epoch> ...
    python -m genpose_tpu_torch.runners.trainer --results_path <results.pkl>

- ``train_score``: score (or ranking-free energy) training with denoising
  score matching (reference ``trainer.py:266-322``), with an optional frozen
  teacher whose score replaces the DSM target (distillation,
  ``trainer.py:406-419``).  Every ``eval_freq`` epochs it samples one pose
  per object of the first train and val batch, logs the mean errors
  (``get_metrics``) and the pose-render grid (``MetricsLogger.image``),
  with ``--save_video`` writes the result grid and the diffusion frames
  under ``<log dir>/video_epoch<N>_<mode>`` (``utils/visualize.py``), and
  saves a checkpoint; a final checkpoint is always written.
- ``train_energy``: with ``ranking``, energy training where a frozen score
  agent generates K=5 candidates per batch online and the energy agent
  learns DSM plus the ranking of those candidates (``trainer.py:325-388``);
  the encoder geometry of the batch is computed once, by the sampling, and
  shared with the energy step.
- ``inference`` (``trainer.py:163-231``): the test set ``repeat_num`` times,
  one sample per object, ``metrics.json`` + ``results.pkl``;
  ``likelihood_eval``: PF-ODE bits of the GT poses, ``likelihood.json``;
  ``evaluation`` (``trainer.py:234-263``): quaternion-averaged hypotheses
  of a ``results.pkl`` against GT, ``average_results.pkl`` (never over the
  input); ``prediction`` (``trainer.py:29-160``): K hypotheses ranked by
  energy, averaged and best-energy poses, ``prediction_results.pkl`` and
  ``so3_distribution_<i>.png`` (``utils/so3_visualize.py``).
- ``main``: the NOCS loaders (``data/loader.py``), the three agent types
  (the energy warm start from score weights with re-zeroed heads,
  ``--distillation``, ``energy_with_ranking``), resume under
  ``--use_pretrain`` (the newest ``ckpt_epochN`` and ``clock.json``) and
  the weight resolution of the eval flows (``_resolve_eval_weights``).

A loader is any iterable of raw batches (dicts of numpy arrays, as
``data/loader.py`` and ``data/synthetic.py::synthetic_batch`` make them).
Checkpoints go to ``<out_dir>/ckpts/<log_dir>``, metrics to
``<out_dir>/logs/<log_dir>/metrics.jsonl``, inference results to
``<out_dir>/inference_results/<log_dir>`` and predictions to
``<out_dir>/predictions/<log_dir>`` (``out_dir`` is ``results``, as in JAX).
Randomness comes from one ``torch.Generator`` per flow on the agent's
device, seeded as the JAX keys are: ``cfg.seed`` (``train_score``),
``+ 1`` (``train_energy``), ``+ 2`` (``inference``), ``+ 3``
(``prediction``; the likelihood's exact divergence draws nothing).

The drawing is best-effort, as in the JAX runner: where it fails (the
card's machine has no matplotlib for the SO(3) images), a line says why
and the flow goes on.  ``--save_video`` writes each sample's diffusion
steps as numbered PNG frames where the JAX runner encodes an mp4
(``utils/visualize.py::save_video``).

Several devices (``--num_devices N``, 0 = every visible card, the JAX
meaning of the flag): ``main`` starts N spawned workers, one per device
(``parallel.launch``; gloo CPU processes under ``--device cpu``), or,
started by ``torchrun``, joins the group its environment names.  The
training flows then run data-parallel as the JAX trainer's mesh does
(``genpose_tpu/runners/trainer.py:97-99``): ``--batch_size`` is the global
batch, rank r's loader yields rank r's rows of it, and each step runs
inside ``parallel.sharded`` (the draws of the global batch, BatchNorm
statistics and the gradient mean over the group; the teacher's RK45 norm
over every rank's rows).  The agents are broadcast from rank 0 after every
load.  Logged losses are means over the ranks; the eval epoch gathers the
first train batch and samples it whole on every rank, as the JAX trainer
samples it unsharded.  Rank 0 alone writes checkpoints, ``clock.json``,
``metrics.jsonl`` and images.  The flows that train nothing (``--eval``,
``--pred``, ``--likelihood``, ``--results_path``) run in one process: the
JAX trainer shards only its training batches.  Under ``torchrun`` they run
on rank 0, and the other ranks return at once.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time
from typing import Iterable, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import Config, get_config
from genpose_tpu_torch.data.loader import get_data_loaders_from_cfg
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.eval.metrics import get_metrics
from genpose_tpu_torch.ops.pose import (
    average_quaternion_batch,
    get_rot_matrix,
    matrix_to_quat_wxyz,
)
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    load_clock,
    save_checkpoint,
)
from genpose_tpu_torch.training.ranking import sort_poses_by_energy
from genpose_tpu_torch.utils.device import resolve_device, runner_device
from genpose_tpu_torch.utils.logging import MetricsLogger, TrainClock

NUM_CANDIDATES = 5  # score-model candidates per object for the ranking loss (trainer.py:196)


def results_dirs(cfg: Config, out_dir: str = "results"):
    """(checkpoint directory, log directory) of a run."""
    return (os.path.join(out_dir, "ckpts", cfg.log_dir),
            os.path.join(out_dir, "logs", cfg.log_dir))


def _generator(agent: PoseAgent, seed: int) -> torch.Generator:
    return torch.Generator(device=agent.device).manual_seed(seed)


class _NullLogger:
    """The metrics logger of a rank that writes nothing (every rank but 0)."""
    log_dir = None

    def scalar(self, *args, **kwargs):
        pass

    scalars = image = scalar

    def close(self):
        pass


def _logger(log_dir: str, group: Optional[parallel.DPGroup]):
    return MetricsLogger(log_dir) if group is None or group.is_writer else _NullLogger()


def _log_losses(logger, losses: dict, step: int, group, prefix: str = "train/") -> None:
    losses = parallel.mean_over_ranks(losses, group)
    logger.scalars({k: float(v) for k, v in losses.items()}, step, prefix=prefix)


def _save(ckpt_dir: str, agent: PoseAgent, clock: TrainClock, group) -> None:
    if group is None or group.is_writer:
        save_checkpoint(ckpt_dir, agent, clock.epoch, clock.make_checkpoint())


def _first_batch(loader, group):
    """The first raw batch of ``loader``; of a sharded loader, the whole
    global batch gathered from every rank's rows."""
    raw = next(iter(loader), None)
    if getattr(loader, "shard", None) is None or group is None:
        return raw
    parts = parallel.all_gather_objects(group, raw)
    if any(p is None for p in parts):
        return None
    return {k: (sum((p[k] for p in parts), []) if isinstance(parts[0][k], list)
                else np.concatenate([p[k] for p in parts])) for k in parts[0]}


def _batch_errors(cfg: Config, pose: torch.Tensor, gt: torch.Tensor, batch, pose_mode: str):
    """(rotation error [bs] in degrees, translation error [bs] in cm)."""
    return get_metrics(pose.cpu().numpy(), gt.cpu().numpy(), batch["id"].cpu().numpy(),
                       cfg.synset_names, batch["handle_visibility"].cpu().numpy(), pose_mode,
                       cfg.o2c_pose)


def _visualize_eval(cfg: Config, logger: MetricsLogger, batch, pred: torch.Tensor,
                    process: Optional[torch.Tensor], mode: str, epoch: int) -> None:
    """The pose-render grid to the metrics logger and, with ``--save_video``,
    the result grid and the diffusion frames (JAX ``trainer.py:57-79``; ref
    ``posenet_agent.py:343-351, 590-598``).  Best-effort: the eval metrics
    never depend on the drawing."""
    try:
        from genpose_tpu_torch.utils.visualize import create_grid_image, test_time_visualize

        pts, gt = batch["pts"].cpu().numpy(), batch["gt_pose"].cpu().numpy()
        grid, _ = create_grid_image(pts, pred.cpu().numpy(), gt, None, cfg.pose_mode,
                                    cfg.o2c_pose)
        logger.image(f"{mode}/pose_render", grid.transpose(2, 0, 1), epoch)
        if cfg.save_video and process is not None:
            test_time_visualize(os.path.join(logger.log_dir, f"video_epoch{epoch}_{mode}"),
                                {"pts": pts, "gt_pose": gt}, pred.cpu().numpy(),
                                process.cpu().numpy(), cfg.pose_mode, cfg.o2c_pose)
    except Exception as e:
        print(f"eval visualization skipped: {e}")


def _eval_epoch(cfg: Config, agent: PoseAgent, loaders, logger: MetricsLogger,
                epoch: int, generator: torch.Generator, group=None) -> None:
    """One sampled pose per object of the first batch of each loader, its
    mean rotation / translation errors and its pictures; with
    ``--save_video`` the sampling also returns its trajectory, by the
    fixed-step PF-ODE where the config's sampler is the adaptive one (JAX
    ``trainer.py:123-133``).  Under a group every rank samples the whole
    first batch (gathered from a sharded loader), unsharded, as JAX does;
    rank 0 logs and draws."""
    for loader, mode in loaders:
        raw = _first_batch(loader, group)
        if raw is None:
            continue
        batch = process_batch(raw, cfg.pose_mode, mini_batch_size=cfg.mini_bs,
                              device=agent.device)
        process = None
        if cfg.save_video:
            adaptive = bool(cfg.sampler_mode) and cfg.sampler_mode[0] == "ode_adaptive"
            process, pred = agent.sample(batch, generator=generator, repeat_num=1,
                                         sampler="ode" if adaptive else None,
                                         num_steps=cfg.sampling_steps, return_process=True)
            process = process[:, 0]
        else:
            pred = agent.sample(batch, generator=generator, repeat_num=1,
                                num_steps=cfg.sampling_steps)
        if group is None or group.is_writer:
            _visualize_eval(cfg, logger, batch, pred[:, 0], process, mode, epoch)
        rot_err, trans_err = _batch_errors(cfg, pred[:, 0], batch["gt_pose"], batch,
                                           cfg.pose_mode)
        logger.scalar(f"{mode}/ode_mean_rot_error", float(np.mean(rot_err)), epoch)
        logger.scalar(f"{mode}/ode_mean_trans_error", float(np.mean(trans_err)), epoch)


def train_score(cfg: Config, train_loader: Iterable, val_loader: Iterable, agent: PoseAgent,
                teacher: Optional[PoseAgent] = None, out_dir: str = "results",
                group: Optional[parallel.DPGroup] = None) -> TrainClock:
    """Score (or ranking-free energy) training loop (ref ``trainer.py:266-322``);
    under ``group`` the loaders yield this rank's rows and each step runs
    sharded over the group."""
    ckpt_dir, log_dir = results_dirs(cfg, out_dir)
    logger = _logger(log_dir, group)
    clock = agent.clock = getattr(agent, "clock", TrainClock())
    gen = _generator(agent, cfg.seed)
    last_saved = -1
    try:
        for _ in range(clock.epoch, cfg.n_epochs + 1):
            t_epoch = time.time()
            for raw in train_loader:
                with parallel.sharded(group):
                    batch = process_batch(raw, cfg.pose_mode, gen, cfg.pts_aug,
                                          device=agent.device)
                    losses = (agent.train_step_distill(teacher, batch, gen)
                              if teacher is not None else agent.train_step(batch, gen))
                    clock.tick()
                    if clock.step % 50 == 0:
                        _log_losses(logger, losses, clock.step, group)
                    if cfg.ema_rate > 0 and clock.step % 5 == 0:
                        _log_losses(logger, {"ema": agent.ema_loss(batch, gen)}, clock.step,
                                    group)
            logger.scalar("epoch_time_s", time.time() - t_epoch, clock.epoch)
            clock.tock()
            if clock.epoch % cfg.eval_freq == 0:
                _eval_epoch(cfg, agent, ((train_loader, "train"), (val_loader, "val")),
                            logger, clock.epoch, gen, group)
                _save(ckpt_dir, agent, clock, group)
                last_saved = clock.epoch
        # always leave a final checkpoint, also when n_epochs < eval_freq
        if last_saved != clock.epoch:
            _save(ckpt_dir, agent, clock, group)
    finally:
        logger.close()
    return clock


def train_energy(cfg: Config, train_loader: Iterable, val_loader: Iterable,
                 energy_agent: PoseAgent, score_agent: Optional[PoseAgent] = None,
                 ranking: bool = False, out_dir: str = "results",
                 group: Optional[parallel.DPGroup] = None) -> TrainClock:
    """Energy training (ref ``trainer.py:325-388``).  Without ranking it is
    ``train_score`` with ``score_agent`` as the distillation teacher; with
    ranking, the frozen ``score_agent`` samples NUM_CANDIDATES poses per
    object online."""
    if not ranking:
        return train_score(cfg, train_loader, val_loader, energy_agent, teacher=score_agent,
                           out_dir=out_dir, group=group)
    if score_agent is None:
        raise ValueError("ranking needs a score agent to generate candidates")
    ckpt_dir, log_dir = results_dirs(cfg, out_dir)
    logger = _logger(log_dir, group)
    clock = energy_agent.clock = getattr(energy_agent, "clock", TrainClock())
    gen = _generator(energy_agent, cfg.seed + 1)
    last_saved = -1
    try:
        for _ in range(clock.epoch, cfg.n_epochs + 1):
            for raw in train_loader:
                with parallel.sharded(group):
                    batch = process_batch(raw, cfg.pose_mode, gen, cfg.pts_aug,
                                          device=energy_agent.device)
                    # the candidates' sampling and the energy step encode the same
                    # augmented points: one geometry pass (FPS + ball query) for both
                    pose_samples, geom = score_agent.sample(
                        batch, generator=gen, repeat_num=NUM_CANDIDATES,
                        num_steps=cfg.sampling_steps, return_geometry=True)
                    losses = energy_agent.train_step_energy(batch, pose_samples, gen,
                                                            geometry=geom)
                    clock.tick()
                    if clock.step % 50 == 0:
                        _log_losses(logger, losses, clock.step, group)
            clock.tock()
            if clock.epoch % cfg.eval_freq == 0:
                _save(ckpt_dir, energy_agent, clock, group)
                last_saved = clock.epoch
        if last_saved != clock.epoch:
            _save(ckpt_dir, energy_agent, clock, group)
    finally:
        logger.close()
    return clock


def inference(cfg: Config, test_loader: Iterable, agent: PoseAgent,
              out_dir: str = "results") -> str:
    """The test set ``repeat_num`` times, one sampled pose per object and
    batches ``0..max_eval_num`` (``>``, as the reference's ``trainer.py:38``):
    ``metrics.json`` (each repeat's errors) and ``results.pkl`` (the
    ``repeat_num`` poses per object, GT, class and handle visibility) under
    ``<out_dir>/inference_results/<log_dir>/<test_source>_<sampler>_<steps>``.
    Returns the path of ``results.pkl``."""
    gen = _generator(agent, cfg.seed + 2)
    metrics, results = {}, {}
    for i in range(cfg.repeat_num):
        errs, preds, gts, ids, hvs = [], [], [], [], []
        for index, raw in enumerate(test_loader):
            if index > cfg.max_eval_num:
                break
            batch = process_batch(raw, cfg.pose_mode, device=agent.device)
            pred = agent.sample(batch, generator=gen, repeat_num=1,
                                num_steps=cfg.sampling_steps)[:, 0]
            errs.append(np.stack(_batch_errors(cfg, pred, batch["gt_pose"], batch,
                                               cfg.pose_mode), axis=1))
            preds.append(pred.cpu().numpy())
            gts.append(batch["gt_pose"].cpu().numpy())
            ids.append(batch["id"].cpu().numpy())
            hvs.append(batch["handle_visibility"].cpu().numpy())
        err = np.concatenate(errs)
        print(f"[{i + 1}/{cfg.repeat_num}] MEAN ROT {err[:, 0].mean():.2f} deg  "
              f"MEAN TRANS {err[:, 1].mean():.2f} cm  MEDIAN ROT {np.median(err[:, 0]):.2f}")
        metrics[f"index_{i}"] = err.tolist()
        pred_cat = np.concatenate(preds)[:, None]
        if i == 0:
            results = {"pred_pose": pred_cat, "gt_pose": np.concatenate(gts),
                       "cls_id": np.concatenate(ids), "handle_visibility": np.concatenate(hvs)}
        else:
            results["pred_pose"] = np.concatenate([results["pred_pose"], pred_cat], axis=1)

    sampler = cfg.sampler_mode[0] if cfg.sampler_mode else "ode"
    save_path = os.path.join(out_dir, "inference_results", cfg.log_dir,
                             f"{cfg.test_source}_{sampler}_{cfg.sampling_steps}")
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    results_path = os.path.join(save_path, "results.pkl")
    with open(results_path, "wb") as f:
        pickle.dump(results, f)
    return results_path


def likelihood_eval(cfg: Config, test_loader: Iterable, agent: PoseAgent,
                    out_dir: str = "results") -> dict:
    """PF-ODE log-likelihood of the GT poses over the test batches
    ``0..max_eval_num`` (the reference's 'likelihood' forward mode,
    ``posenet.py:166-168``): mean, median and per-class mean bits in
    ``<out_dir>/inference_results/<log_dir>/<test_source>_likelihood/likelihood.json``."""
    all_bits, all_ids = [], []
    for index, raw in enumerate(test_loader):
        if index > cfg.max_eval_num:
            break
        batch = process_batch(raw, cfg.pose_mode, device=agent.device)
        _, bits = agent.likelihood(batch, batch["zero_mean_gt_pose"],
                                   num_steps=cfg.sampling_steps)
        all_bits.append(bits.cpu().numpy())
        all_ids.append(batch["id"].cpu().numpy())
    bits, ids = np.concatenate(all_bits), np.concatenate(all_ids)
    summary = {"mean_bits": float(bits.mean()), "median_bits": float(np.median(bits)),
               "n": int(bits.shape[0])}
    for cls_id in np.unique(ids):
        name = (cfg.synset_names[int(cls_id)] if int(cls_id) < len(cfg.synset_names)
                else str(int(cls_id)))
        summary[f"mean_bits/{name}"] = float(bits[ids == cls_id].mean())
    save_path = os.path.join(out_dir, "inference_results", cfg.log_dir,
                             f"{cfg.test_source}_likelihood")
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "likelihood.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"LIKELIHOOD mean {summary['mean_bits']:.3f} bits "
          f"(median {summary['median_bits']:.3f}, n={summary['n']})")
    return summary


def _quat_pose(pose: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """[..., pose_dim] in ``pose_mode`` -> [..., 7] wxyz quaternion + t."""
    rot = get_rot_matrix(pose.reshape(-1, pose.shape[-1])[:, :-3], pose_mode)
    quat = matrix_to_quat_wxyz(rot).reshape(pose.shape[:-1] + (4,))
    return torch.cat([quat, pose[..., -3:]], dim=-1)


def evaluation(cfg: Config, device="cuda") -> np.ndarray:
    """Errors of a ``results.pkl``'s quaternion-averaged hypotheses against
    GT (ref ``trainer.py:234-263``): [N, 2] (degrees, cm), written to
    ``average_results.pkl`` beside it, or ``<input>.average_results.pkl``
    when the input's name does not hold ``results.pkl`` (never over the
    input).  Runs on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    with open(cfg.results_path, "rb") as f:
        results = pickle.load(f)
    pred = torch.as_tensor(np.asarray(results["pred_pose"], np.float32), device=device)
    avg_q = average_quaternion_batch(_quat_pose(pred, cfg.pose_mode)[..., :4])
    avg_pose = torch.cat([avg_q, torch.mean(pred[..., -3:], dim=1)], dim=-1)
    gt = torch.as_tensor(np.asarray(results["gt_pose"], np.float32), device=device)
    rot_error, trans_error = get_metrics(
        avg_pose.cpu().numpy(), _quat_pose(gt, cfg.pose_mode).cpu().numpy(),
        np.asarray(results["cls_id"]), cfg.synset_names,
        np.asarray(results["handle_visibility"]), "quat_wxyz", cfg.o2c_pose)
    error = np.stack([rot_error, trans_error], axis=1)
    out = cfg.results_path.replace("results.pkl", "average_results.pkl")
    if out == cfg.results_path:
        out = cfg.results_path + ".average_results.pkl"
    with open(out, "wb") as f:
        pickle.dump(error, f)
    print("Mean Rotation Error: ", rot_error.mean())
    print("Median Rotation Error: ", np.median(rot_error))
    print("Mean Translation Error: ", trans_error.mean())
    print("Median Translation Error: ", np.median(trans_error))
    return error


def prediction(cfg: Config, test_loader: Iterable, agent: PoseAgent,
               energy_agent: Optional[PoseAgent] = None, out_dir: str = "results") -> list:
    """``repeat_num`` hypotheses per object of the test batches
    ``0..max_eval_num``, ranked by ``energy_agent`` (by ``agent`` when it is
    an energy agent; a score-only run takes the first hypothesis), the
    quaternion-averaged and the best-energy pose with their errors:
    ``<out_dir>/predictions/<log_dir>/prediction_results.pkl`` (ref
    ``trainer.py:29-160``), and for the first batch's first 8 objects
    ``so3_distribution_<i>.png``: the hypotheses' SO(3) scatter beside the
    object's grid image (best-effort, as in JAX)."""
    e_agent = energy_agent or agent
    gen = _generator(agent, cfg.seed + 3)
    save_dir = os.path.join(out_dir, "predictions", cfg.log_dir)
    os.makedirs(save_dir, exist_ok=True)
    all_res = []
    for index, raw in enumerate(test_loader):
        if index > cfg.max_eval_num:
            break
        batch = process_batch(raw, cfg.pose_mode, device=agent.device)
        pred = agent.sample(batch, generator=gen, repeat_num=cfg.repeat_num,
                            num_steps=cfg.sampling_steps)  # [bs, K, pose_dim]
        if e_agent.mode == "energy":
            energy = e_agent.get_energy(batch, pred, T=1e-5)
            chosen = sort_poses_by_energy(pred, energy)[0][:, 0]
        else:
            energy = torch.zeros(pred.shape[:2] + (2,), device=pred.device)
            chosen = pred[:, 0]
        pred_q, avg = agent.aggregate_hypotheses(pred)
        gt_q = _quat_pose(batch["gt_pose"], cfg.pose_mode)
        chosen_q = _quat_pose(chosen, cfg.pose_mode)
        for name, pose in (("average", avg), ("best_energy", chosen_q)):
            err = np.stack(_batch_errors(cfg, pose, gt_q, batch, "quat_wxyz"), axis=1)
            print(f"[batch {index}] {name}: mean error {err.mean(0)}  "
                  f"median error {np.median(err, 0)}")
        all_res.append({"pred_pose": pred_q.cpu().numpy(), "average_pred_pose": avg.cpu().numpy(),
                        "choosed_pred_pose": chosen_q.cpu().numpy(),
                        "gt_pose": gt_q.cpu().numpy(), "energy": energy.cpu().numpy(),
                        "pts": batch["pts"].cpu().numpy()})
    _visualize_prediction(cfg, all_res[0] if all_res else None, save_dir)
    with open(os.path.join(save_dir, "prediction_results.pkl"), "wb") as f:
        pickle.dump(all_res, f)
    print(f"prediction artifacts -> {save_dir}")
    return all_res


def _visualize_prediction(cfg: Config, first: Optional[dict], save_dir: str) -> None:
    """JAX ``trainer.py:408-429``: per object of the first batch (at most 8)
    the SO(3) distribution of its hypotheses, the pooled and the GT rotation,
    beside its grid image."""
    try:
        from genpose_tpu_torch.utils.so3_visualize import visualize_so3
        from genpose_tpu_torch.utils.visualize import create_grid_image

        def rot(quat_pose):
            return get_rot_matrix(torch.as_tensor(quat_pose), "quat_wxyz").numpy()

        for i in range(min(first["pred_pose"].shape[0], 8)):
            grid, _ = create_grid_image(first["pts"][i:i + 1],
                                        first["average_pred_pose"][i:i + 1],
                                        first["gt_pose"][i:i + 1], None, pose_mode="quat_wxyz",
                                        inverse_pose=cfg.o2c_pose)
            visualize_so3(save_path=os.path.join(save_dir, f"so3_distribution_{i}.png"),
                          pred_rotations=rot(first["pred_pose"][i][:, :-3]),
                          pred_rotation=rot(first["average_pred_pose"][i:i + 1, :-3]),
                          gt_rotation=rot(first["gt_pose"][i:i + 1, :-3]), image=grid)
    except Exception as e:
        print(f"visualization skipped: {e}")


def _load_pretrained(agent: PoseAgent, path: str, load_model_only: bool = True) -> None:
    load_checkpoint(path, agent, load_model_only)


def _resolve_eval_weights(cfg: Config, agent: PoseAgent, ckpt_dir: str) -> None:
    """Weights for the ``--eval`` / ``--pred`` / ``--likelihood`` flows, first
    found: the path flag of the agent's mode (``--pretrained_energy_model_path``
    or ``--pretrained_score_model_path``), ``ckpt_epoch<--model_name>`` in
    ``ckpt_dir`` (a missing one raises), the state a ``--use_pretrain``
    resume restored, the newest checkpoint in ``ckpt_dir``; else a warning
    that the seeded initial weights are evaluated."""
    explicit = None
    if agent.mode == "energy" and cfg.pretrained_energy_model_path:
        explicit = cfg.pretrained_energy_model_path
    elif agent.mode == "score" and cfg.pretrained_score_model_path:
        explicit = cfg.pretrained_score_model_path
    if explicit:
        _load_pretrained(agent, explicit)
        return
    if cfg.model_name:
        path = os.path.join(ckpt_dir, f"ckpt_epoch{cfg.model_name}")
        if not os.path.exists(path):
            raise FileNotFoundError(f"--model_name {cfg.model_name}: no checkpoint at {path}")
        _load_pretrained(agent, path)
        return
    if cfg.use_pretrain:
        return  # the resume restored the newest state
    path = latest_checkpoint(ckpt_dir)
    if path:
        _load_pretrained(agent, path)
        return
    print(f"WARNING: no checkpoint to evaluate (no weight flags and none under {ckpt_dir}) "
          "- running with the seeded initial weights")


def main(argv=None, out_dir: str = "results"):
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = get_config(argv)
    training = not (cfg.eval or cfg.pred or cfg.likelihood or cfg.results_path)
    rank = int(os.environ.get("RANK", 0))
    if not training and rank > 0:  # torchrun: the flow and its files are rank 0's
        print(f"rank {rank}: nothing to do, the flows that train nothing run on rank 0")
        return
    if training and cfg.device != "cpu":
        parallel.resolve_num_devices(cfg.num_devices, "cuda")  # more cards than there are raises
    device = runner_device(cfg)
    if cfg.results_path:
        print("Start evaluate ...")
        evaluation(cfg, device)
        print("Evaluate finished!")
        return
    joined = torch.distributed.is_initialized() or "WORLD_SIZE" in os.environ
    if training and joined:
        return _group_main(parallel.make_group(cfg.num_devices, device), argv, out_dir)
    world = parallel.resolve_num_devices(cfg.num_devices, device)
    if training and world > 1:
        print(f"Training on {world} devices ({device.type}), one process each")
        parallel.launch(_group_main, world, device, args=(argv, out_dir))
        return
    _main(cfg, device, None, out_dir)


def _group_main(group: parallel.DPGroup, argv, out_dir: str) -> None:
    """One rank's training run (``main``'s workers, or a ``torchrun`` process)."""
    _main(get_config(argv), group.device, group, out_dir)


def _main(cfg: Config, device, group: Optional[parallel.DPGroup], out_dir: str) -> None:
    shard = (group.rank, group.world) if group is not None else None
    if not (cfg.eval or cfg.pred or cfg.likelihood):
        loaders = get_data_loaders_from_cfg(cfg, ["train", "val", "test"], shard=shard)
        steps_per_epoch = max(1, len(loaders["train_loader"]))
    else:
        loaders = get_data_loaders_from_cfg(cfg, ["test"])
        steps_per_epoch = 1000
    try:
        _run_flows(cfg, device, loaders, steps_per_epoch, out_dir, group)
    finally:
        for ld in loaders.values():  # the process pools of loader_mode='process'
            ld.close()


def _run_flows(cfg: Config, device, loaders, steps_per_epoch: int, out_dir: str,
               group: Optional[parallel.DPGroup] = None) -> None:
    def agent(mode):
        return PoseAgent(cfg, mode, device=device, steps_per_epoch=steps_per_epoch)

    if cfg.agent_type == "score":
        tr_agent = score_agent = agent("score")
    elif cfg.agent_type == "energy":
        tr_agent, score_agent = agent("energy"), None
        if cfg.pretrained_score_model_path:
            # warm-start the energy net from the score net, its output layers
            # re-zeroed (ref trainer.py:425-426)
            _load_pretrained(tr_agent, cfg.pretrained_score_model_path)
            tr_agent.zero_head_outputs()
        if cfg.distillation:
            if not cfg.pretrained_score_model_path:
                raise ValueError("--distillation requires --pretrained_score_model_path")
            score_agent = agent("score")
            _load_pretrained(score_agent, cfg.pretrained_score_model_path)
    elif cfg.agent_type == "energy_with_ranking":
        if not cfg.pretrained_score_model_path:
            raise ValueError("energy_with_ranking requires --pretrained_score_model_path")
        score_agent, tr_agent = agent("score"), agent("energy")
        _load_pretrained(score_agent, cfg.pretrained_score_model_path)
        if cfg.pretrained_energy_model_path:
            _load_pretrained(tr_agent, cfg.pretrained_energy_model_path)
    else:
        raise NotImplementedError(cfg.agent_type)

    ckpt_dir, _ = results_dirs(cfg, out_dir)
    if cfg.use_pretrain:
        path = latest_checkpoint(ckpt_dir)
        if path:
            load_checkpoint(path, tr_agent, load_model_only=False)
            tr_agent.clock = TrainClock.restored(load_clock(ckpt_dir))
    # after every load, every rank holds rank 0's state (JAX: replicated placement)
    parallel.replicate(group, *{id(a): a for a in (tr_agent, score_agent) if a is not None}
                       .values())

    test_loader = loaders["test_loader"]
    if cfg.eval or cfg.likelihood or cfg.pred:
        _resolve_eval_weights(cfg, tr_agent, ckpt_dir)
    if cfg.eval:
        print("Start inference ...")
        inference(cfg, test_loader, tr_agent, out_dir)
        print("Inference finished")
        return
    if cfg.likelihood:
        print("Start likelihood evaluation ...")
        likelihood_eval(cfg, test_loader, tr_agent, out_dir)
        print("Likelihood evaluation finished")
        return
    if cfg.pred:
        print("Start prediction ...")
        energy_agent = tr_agent if cfg.agent_type != "score" else None
        score = score_agent if cfg.agent_type != "energy" else tr_agent
        prediction(cfg, test_loader, score, energy_agent, out_dir)
        print("Prediction finished")
        return

    train_loader, val_loader = loaders["train_loader"], loaders["val_loader"]
    if cfg.agent_type == "score":
        train_score(cfg, train_loader, val_loader, tr_agent, out_dir=out_dir, group=group)
    else:
        train_energy(cfg, train_loader, val_loader, tr_agent, score_agent,
                     ranking=cfg.agent_type == "energy_with_ranking", out_dir=out_dir,
                     group=group)


if __name__ == "__main__":
    main()
