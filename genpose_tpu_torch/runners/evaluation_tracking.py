"""Pose-tracking evaluation (counterpart of ``genpose_tpu/runners/evaluation_tracking.py``).

Frame by frame over the sorted Real test list: the previous frame's pooled
pose (matched by model name) seeds the sampler as ``init_x`` with a reduced
start time ``T0`` (0.15 in ``scripts/eval_tracking.sh``); objects not seen
before start from their ground truth with noise (``add_noise_to_RT``).
Hypotheses are energy-sorted and the top 60% quaternion-averaged; per-class
mean (deg, cm) errors and 5deg5cm accuracy are reported (ref
``:221-245, 262-337``).

Per frame, ``track_frame`` runs the JAX runner's ``frame_pipeline``
(``:167-190``) on the agents' device: the geometry once (FPS + ball query:
the CUDA kernels on a card), shared by the score and the energy encoder; K
samples from the ``init_x`` + T0 prior; energies; the decoupled sort; the
top-60% quaternion pool.  As in the JAX runner, a frame's instances (and
their ``init_x`` rows) are padded to the next power of two with copies of
the last, and only the first rows are kept: the adaptive RK45 sampler picks
one step size for all rows, and PC one Langevin step from all rows, so the
real rows integrate as the JAX runner's do.  The sampler is
``cfg.sampler_mode[0]``, every one of them frozen.  ``main_tracking`` freezes both agents before the frame loop (JAX
closes ``frame_pipeline`` over the pinned states), so on a card each
power-of-two bucket replays one set of CUDA graphs.  One worker thread
decodes frame n+1 while the device runs frame n.

Usage: ``python -m genpose_tpu_torch.runners.evaluation_tracking
--data_path <nocs> --result_dir <results> --test_source real_test
--T0 0.15 --device cpu`` (``--device`` as in ``evaluation_single``).
"""

from __future__ import annotations

import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import Config, get_config
from genpose_tpu_torch.data.dataset_utils import load_depth
from genpose_tpu_torch.eval.metrics import compute_RT_errors
from genpose_tpu_torch.ops.pose import (
    average_quaternion_batch,
    matrix_to_quat_wxyz,
    quat_wxyz_to_matrix,
)
from genpose_tpu_torch.runners.evaluation_single import (
    REAL_K,
    _instance_points,
    load_agent,
    mrcnn_path,
    pad_rows,
    zero_center_batch,
)
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.ranking import sort_poses_by_energy
from genpose_tpu_torch.utils.device import runner_device
from genpose_tpu_torch.utils.tracking import add_noise_to_RT, srt_to_pose9d


def cal_average_sRT(sRT: np.ndarray, selected_num: int) -> np.ndarray:
    """Quaternion-average the first ``selected_num`` hypotheses [bs, K, 4, 4]
    (ref ``evaluation_tracking.py:60-77``), in float32 as the JAX runner."""
    bs = sRT.shape[0]
    sel = torch.as_tensor(sRT[:, :selected_num].reshape(bs * selected_num, 4, 4),
                          dtype=torch.float32)
    quat = matrix_to_quat_wxyz(sel[:, :3, :3]).reshape(bs, selected_num, 4)
    trans = sel[:, :3, 3].reshape(bs, selected_num, 3)
    out = np.tile(np.identity(4), (bs, 1, 1))
    out[:, :3, :3] = quat_wxyz_to_matrix(average_quaternion_batch(quat)).numpy()
    out[:, :3, 3] = torch.mean(trans, dim=1).numpy()
    return out


def extract_single_frame_data(cfg: Config, path: str, rng) -> Optional[dict]:
    """Tracking-layout Mask R-CNN pkl -> per-instance clouds (ref ``:110-186``).
    Every per-instance field is filtered by the same keep mask."""
    img_path = os.path.join(cfg.data_path, path)
    raw_depth = load_depth(img_path)
    with open(mrcnn_path(cfg, img_path), "rb") as f:
        mrcnn_result = pickle.load(f)
    num_insts = len(mrcnn_result["pred"]["class_ids"])

    f_points, f_catId, f_gt, f_names, f_hv, f_seen = [], [], [], [], [], []
    seen = mrcnn_result["pred"].get("seen")
    for i in range(num_insts):
        mask = np.logical_and(mrcnn_result["pred"]["masks"][:, :, i], raw_depth > 0)
        pts = _instance_points(raw_depth, mask, mrcnn_result["pred"]["rois"][i], REAL_K,
                               cfg.img_size, cfg.num_points, rng)
        if pts is None:
            continue
        # normalise away any scale in the GT pose (ref :175)
        gtp = np.array(mrcnn_result["gt"]["poses"][i])
        gtp[:3, :3] = gtp[:3, :3] / np.linalg.norm(gtp[:3, 0])
        f_points.append(pts)
        f_catId.append(mrcnn_result["pred"]["class_ids"][i] - 1)
        f_gt.append(gtp)
        f_names.append(mrcnn_result["gt"]["model_list"][i])
        f_hv.append(mrcnn_result["gt"]["handle_visibility"][i])
        if seen is not None:
            f_seen.append(seen[i])

    if not f_points:
        return None
    return {
        "gt_handle_visibility": np.asarray(f_hv),
        "gt_pose": np.asarray(f_gt),
        # read for format parity; seeding goes by model name (ref :183, 302-310)
        "tracked": f_seen if seen is not None else None,
        "model_name": f_names,
        "pts": f_points,
        "cat_id": f_catId,
    }


def aggregate_tracking_metrics(errors: Dict[str, list]) -> Dict[str, dict]:
    """Per-class mean error + 5deg5cm accuracy (ref ``:221-245``)."""
    cls: Dict[str, np.ndarray] = {}
    for key, errs in errors.items():
        cls_name = key.split("_")[0]
        arr = np.array(errs)
        cls[cls_name] = arr if cls_name not in cls else np.concatenate([cls[cls_name], arr], 0)
    metrics: Dict[str, dict] = {}
    for name, errs in cls.items():
        metrics[name] = {
            "mean_error": np.mean(errs, axis=0),
            "5d5cm_acc": float(np.sum(
                np.logical_and(errs[:, 0] <= 5, errs[:, 1] <= 5)) / errs.shape[0]),
        }
    n = len(metrics)
    total = {"mean_error": 0.0, "5d5cm_acc": 0.0}
    for m in metrics.values():
        total["mean_error"] = total["mean_error"] + m["mean_error"] / n
        total["5d5cm_acc"] += m["5d5cm_acc"] / n
    metrics["all"] = total
    return metrics


@torch.no_grad()
def track_frame(cfg: Config, score_agent: PoseAgent, energy_agent: PoseAgent,
                batch: Dict[str, torch.Tensor], init_pose: Optional[torch.Tensor],
                T0: float, generator: Optional[torch.Generator] = None):
    """One frame's device chain (JAX ``frame_pipeline``): shared geometry ->
    K samples from the ``init_x`` + T0 prior -> energies -> decoupled sort ->
    top-60% quaternion pool, over the n instances padded to a power of two
    (JAX ``evaluation_tracking.py:228-242``).  Returns (R [n, 3, 3], t [n, 3])."""
    K = cfg.eval_repeat_num
    keep = max(1, int(0.6 * K))
    n = batch["zero_mean_pts"].shape[0]
    rows = 1 << (n - 1).bit_length()
    batch = {k: pad_rows(v, rows) for k, v in batch.items()}
    if init_pose is not None:
        init_pose = pad_rows(init_pose, rows)
    geom = score_agent.pts_geometry(batch["zero_mean_pts"])
    pred = score_agent.sample(batch, generator=generator, repeat_num=K,
                              num_steps=cfg.sampling_steps, T0=T0, init_x=init_pose,
                              geometry=geom)
    energy = energy_agent.get_energy(batch, pred, T=1e-5, geometry=geom)
    sorted_pose, _ = sort_poses_by_energy(pred, energy)
    _, avg = score_agent.aggregate_hypotheses(sorted_pose[:, :keep])
    return quat_wxyz_to_matrix(avg[:n, :4]), avg[:n, 4:]


NoiseDraws = Callable[[int, int], tuple]


def main_tracking(cfg: Config, tracking: bool = True, T0: float = 0.15, device="cuda",
                  score_agent: Optional[PoseAgent] = None,
                  energy_agent: Optional[PoseAgent] = None,
                  generator: Optional[torch.Generator] = None,
                  noise_draws: Optional[NoiseDraws] = None):
    """Sequential frame loop (ref ``evaluation_tracking.py:262-337``).

    Agents default to ``evaluation_single.load_agent`` on ``device`` (the
    checkpoints under ``results/ckpts``); given or not, both are frozen
    here (``PoseAgent.freeze``) for the run.  The prior and the pose noise come
    from ``generator`` (default: seeded ``cfg.seed`` on the agents' device);
    ``noise_draws(frame, n)``, if given, returns a frame's
    ``add_noise_to_RT`` draws instead (``frame`` counts the frames tracked).
    Returns the metrics of ``aggregate_tracking_metrics``.
    """
    rng = np.random.default_rng(cfg.seed)
    if score_agent is None:
        score_agent = load_agent(cfg, "score", cfg.score_model_dir, device)
    if energy_agent is None:
        energy_agent = load_agent(cfg, "energy", cfg.energy_model_dir, device)
    score_agent.freeze()
    energy_agent.freeze()
    dev = score_agent.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    with open(os.path.join(cfg.data_path, "Real/test_list.txt")) as f:
        img_list = sorted(os.path.join("Real", line.rstrip("\n")) for line in f)

    errors: Dict[str, list] = {}
    buffer = {"model_name": [], "pred_sRT": None}
    n_tracked = 0

    # the worker thread alone uses rng, one frame at a time, so the sampled
    # points follow the frame order; the prior needs only the previous
    # frame's result, ready before the next iteration starts
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(extract_single_frame_data, cfg, img_list[0], rng) if img_list else None
    try:
        for idx in range(len(img_list)):
            frame = fut.result()
            fut = (pool.submit(extract_single_frame_data, cfg, img_list[idx + 1], rng)
                   if idx + 1 < len(img_list) else None)
            if frame is None:
                continue
            batch = zero_center_batch(frame["pts"], dev)
            N = batch["zero_mean_pts"].shape[0]

            init_pose = None
            if tracking:
                gt = torch.as_tensor(np.asarray(frame["gt_pose"], np.float32)).to(dev)
                draws = noise_draws(n_tracked, N) if noise_draws is not None else None
                init_sRT = add_noise_to_RT(gt, generator=generator, draws=draws).cpu().numpy()
                for i, name in enumerate(frame["model_name"]):
                    if name in buffer["model_name"]:
                        init_sRT[i] = buffer["pred_sRT"][buffer["model_name"].index(name)]
                init_pose = srt_to_pose9d(torch.as_tensor(init_sRT).to(dev))
                init_pose[:, -3:] -= batch["pts_center"]
            n_tracked += 1

            avg_R, avg_t = track_frame(cfg, score_agent, energy_agent, batch, init_pose, T0,
                                       generator)
            avg_sRT = np.tile(np.identity(4), (N, 1, 1))
            avg_sRT[:, :3, :3] = avg_R.cpu().numpy()
            avg_sRT[:, :3, 3] = avg_t.cpu().numpy()
            buffer["model_name"] = frame["model_name"]
            buffer["pred_sRT"] = avg_sRT

            for i in range(N):
                rt_err = compute_RT_errors(avg_sRT[i], frame["gt_pose"][i],
                                           int(frame["cat_id"][i]),
                                           frame["gt_handle_visibility"][i], cfg.synset_names)
                errors.setdefault(frame["model_name"][i], []).append(
                    np.asarray(rt_err).tolist())
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    metrics = aggregate_tracking_metrics(errors)
    save_dir = os.path.join(cfg.result_dir, "evaluation_results",
                            f"{cfg.test_source}_repeat_{cfg.eval_repeat_num}", "results",
                            cfg.pooling_mode, cfg.ranker)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "eval_logs.txt"), "w") as fw:
        for key_name, m in metrics.items():
            fw.write(key_name + "\n")
            print(key_name)
            for sub, v in m.items():
                fw.write(f"{sub}: {v}\n")
                print(f"{sub}: {v}")
    return metrics


def main(argv=None):
    cfg = get_config(argv if argv is not None else sys.argv[1:])
    return main_tracking(cfg, tracking=True, T0=cfg.T0, device=runner_device(cfg))


if __name__ == "__main__":
    main()
