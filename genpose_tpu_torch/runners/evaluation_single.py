"""Single-frame NOCS evaluation (counterpart of ``genpose_tpu/runners/evaluation_single.py``).

Four stages, writing the JAX runner's files (the pkls are format-compatible
with the reference's ``segmentation_results_*.pkl``):

1. ``detect_mrcnn_results``: Mask R-CNN pkls -> per-instance clouds of
   ``num_points`` points, cached in one segmentation pkl (ref ``:105-260``),
   on the host with ``data/dataset_utils.py`` (no OpenCV);
2. ``inference_pose``: per category, chunks of ``batch_size`` instances, K =
   ``eval_repeat_num`` score-model samples each -> 4x4 RTs,
   ``results_wo_energy.pkl`` and ``cls_data.pkl`` (ref ``:356-425``);
3. ``inference_energy``: energies and the decoupled hypothesis sort,
   ``results_with_energy.pkl`` (ref ``:428-489``);
4. ``evaluate``: NOCS mAP over 46 degree x 21 shift x 101 IoU thresholds,
   ``mAP_Acc.pkl``, ``eval_logs*.txt`` and the curves (ref ``:492-544``);
   ``main`` adds ``mAP_headline.json``.

Stages 2-3 run on the agents' device; each chunk's PointNet++ geometry
(FPS + ball query: the CUDA kernels on a card) is computed once per stage.
As in the JAX runner, every chunk is padded to ``batch_size`` with copies
of its last instance, and the padded rows are dropped from the results.
The padded rows take part in the integration: the adaptive RK45 sampler
picks one step size for all rows and PC's corrector one Langevin step
from the mean score norm over all rows, so the real rows integrate as the
JAX runner's do; and every chunk has one shape, so ``main``'s frozen
agents capture one set of CUDA graphs per stage, under every sampler.

Usage (weights: the port's checkpoints, ``training/checkpoints.py``, found
under ``results/ckpts/<score_model_dir>`` and ``<energy_model_dir>`` as the
JAX runner looks for its own; without them the agents keep their seeded
initialisation):

    python -m genpose_tpu_torch.runners.evaluation_single --data_path <nocs> \\
        --result_dir <results> --test_source real_test --device cpu

``--device`` picks ``cpu`` or ``cuda``; any other value (the config default
is ``tpu``) means the card.

Several devices (``--num_devices N``, 0 = every visible card; JAX
``evaluation_single.py:429-444``): when ``batch_size`` divides over N,
``main`` starts one spawned worker per device (or joins ``torchrun``'s
group) and each padded chunk of stages 2-3 is split over the ranks, sampled
or scored inside ``parallel.sharded`` and gathered, so every rank holds
every chunk's result; else one process runs unsharded.  Each rank freezes
its own agents (CUDA graphs belong to a process).  Rank 0 alone runs stage
1, writes the pickles and runs stage 4.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
from typing import Dict, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import Config, get_config
from genpose_tpu_torch.data.dataset_utils import (
    aug_bbox_eval,
    backproject_and_sample,
    crop_resize_by_warp_affine,
    get_2d_coord_np,
    get_bbox,
    load_depth,
)
from genpose_tpu_torch.data.nocs import CAMERA_INTRINSICS as CAMERA_K
from genpose_tpu_torch.data.nocs import REAL_INTRINSICS as REAL_K
from genpose_tpu_torch.eval.nocs_eval import compute_mAP, plot_mAP
from genpose_tpu_torch.ops.pose import pose_to_rt, rt_to_matrix4
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import latest_checkpoint, load_checkpoint
from genpose_tpu_torch.training.ranking import sort_poses_by_energy
from genpose_tpu_torch.utils.device import runner_device

def intrinsics_for_source(test_source: str) -> np.ndarray:
    return CAMERA_K if test_source == "val" else REAL_K


def file_list_for_source(test_source: str) -> str:
    assert test_source in ("val", "real_test")
    return "CAMERA/val_list.txt" if test_source == "val" else "Real/test_list.txt"


def mrcnn_path(cfg: Config, img_path: str) -> str:
    """The detection pkl of an image (ref ``evaluation_single.py:140-143``)."""
    parts = img_path.split("/")
    return os.path.join(cfg.result_dir, "mrcnn_results", cfg.test_source,
                        "results_{}_{}_{}.pkl".format(cfg.test_source.split("_")[-1],
                                                      parts[-2], parts[-1]))


def _instance_points(raw_depth, mask, bbox, cam_K, img_size, num_points, rng):
    """One instance: square crop -> masked depth -> ``num_points`` cloud, or
    None (ref ``evaluation_single.py:168-216``; the plain eval bbox, no DZI)."""
    im_H, im_W = raw_depth.shape
    rmin, rmax, cmin, cmax = get_bbox(bbox, im_H, im_W)
    bbox_center, scale = aug_bbox_eval((cmin, rmin, cmax, rmax), im_H, im_W)

    coord_2d = get_2d_coord_np(im_W, im_H).transpose(1, 2, 0)
    roi_coord_2d = crop_resize_by_warp_affine(
        coord_2d, bbox_center, scale, img_size).transpose(2, 0, 1)
    roi_mask = crop_resize_by_warp_affine(
        mask.astype(np.float32), bbox_center, scale, img_size)[None]
    roi_depth = crop_resize_by_warp_affine(
        raw_depth.astype(np.float32), bbox_center, scale, img_size)[None]

    if (roi_depth > 0).sum() <= 1.0:
        return None
    if (roi_mask.astype(bool) * (roi_depth > 0)).sum() <= 1.0:
        return None
    n_valid, pcl = backproject_and_sample(
        roi_depth, cam_K, roi_coord_2d, roi_mask, num_points, rng, scale=1.0 / 1000.0)
    if n_valid == 0:
        return None
    return pcl


def _image_list(cfg: Config):
    file_path = file_list_for_source(cfg.test_source)
    with open(os.path.join(cfg.data_path, file_path)) as f:
        return [os.path.join(file_path.split("/")[0], line.rstrip("\n")) for line in f]


def detect_mrcnn_genpose(cfg: Config, save_path: str) -> str:
    """Stage 1: build the per-instance point-cloud cache
    (ref ``evaluation_single.py:105-260``)."""
    cam_K = intrinsics_for_source(cfg.test_source)
    rng = np.random.default_rng(cfg.seed)
    img_list = _image_list(cfg)

    test_data: Dict[str, dict] = {}
    img_count = inst_count = 0
    for path in img_list:
        img_path = os.path.join(cfg.data_path, path)
        raw_depth = load_depth(img_path)
        with open(mrcnn_path(cfg, img_path), "rb") as f:
            mrcnn_result = pickle.load(f)
        num_insts = len(mrcnn_result["class_ids"])
        f_sRT = np.tile(np.identity(4), (num_insts, 1, 1))
        f_size = np.ones((num_insts, 3))

        f_points, f_catId, valid_inst = [], [], []
        for i in range(num_insts):
            mask = np.logical_and(mrcnn_result["masks"][:, :, i], raw_depth > 0)
            pts = _instance_points(raw_depth, mask, mrcnn_result["rois"][i], cam_K,
                                   cfg.img_size, cfg.num_points, rng)
            if pts is None:
                continue
            valid_inst.append(i)
            f_points.append(pts)
            f_catId.append(mrcnn_result["class_ids"][i] - 1)

        if valid_inst:
            img_count += 1
            inst_count += len(valid_inst)

        with open(img_path + "_label.pkl", "rb") as f:
            gts = pickle.load(f)
        result = {
            "gt_class_ids": gts["class_ids"],
            "gt_bboxes": gts["bboxes"],
            "gt_RTs": gts["poses"],
            "gt_scales": gts["size"],
            "gt_handle_visibility": gts["handle_visibility"],
            "pred_class_ids": mrcnn_result["class_ids"],
            "pred_bboxes": mrcnn_result["rois"],
            "pred_scores": mrcnn_result["scores"],
            "pred_RTs": f_sRT,
            "pred_scales": f_size,
        }
        test_data[img_path] = {
            "result": result,
            "valid_pts": f_points,
            "valid_rgb": None,
            "cat_id": f_catId,
            "valid_inst": valid_inst,
        }

    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    with open(save_path, "wb") as f:
        pickle.dump(test_data, f)
    stats_path = save_path.replace("_results_", "_logs_").replace(".pkl", ".txt")
    with open(stats_path, "w") as f:
        f.write(f"Total images: {len(img_list)}\n")
        avg = inst_count / max(img_count, 1)
        f.write(f"Valid images: {img_count},  Total instances: {inst_count},"
                f"  Average: {avg:.2f}/image\n")
    return save_path


def detect_mrcnn_results(cfg: Config, segmentation_results_path: str) -> str:
    if os.path.exists(segmentation_results_path):
        print(f"Segmentation results exist, loading {segmentation_results_path}")
        return segmentation_results_path
    return detect_mrcnn_genpose(cfg, segmentation_results_path)


def unpack_data(cfg: Config, path: str):
    """Group instances by category (ref ``evaluation_single.py:263-306``)."""
    with open(path, "rb") as f:
        detect_result = pickle.load(f)

    categorized = {name: {"img_path": [], "pts": [], "cat_id": [], "inst": []}
                   for name in cfg.synset_names}
    K = cfg.eval_repeat_num
    for key, entry in detect_result.items():
        n = entry["result"]["pred_RTs"].shape[0]
        entry["result"]["multi_hypothesis_pred_RTs"] = np.tile(np.identity(4), (n, K, 1, 1))
        entry["result"]["energy"] = np.zeros((n, K, 2))
        for i, inst in enumerate(entry["valid_inst"]):
            cat_name = cfg.synset_names[entry["cat_id"][i]]
            categorized[cat_name]["img_path"].append(key)
            categorized[cat_name]["pts"].append(entry["valid_pts"][i])
            categorized[cat_name]["cat_id"].append(entry["cat_id"][i])
            categorized[cat_name]["inst"].append(inst)
    return detect_result, categorized


def zero_center_batch(pts, device) -> Dict[str, torch.Tensor]:
    """[n, N, 3] clouds -> {"zero_mean_pts", "pts_center", "pts"} on ``device``."""
    pts = torch.as_tensor(np.asarray(pts, np.float32)).to(device)
    center = torch.mean(pts[:, :, :3], dim=1)
    zm = torch.cat([pts[:, :, :3] - center[:, None, :], pts[:, :, 3:]], dim=-1)
    return {"zero_mean_pts": zm, "pts_center": center, "pts": pts}


def pose_to_rts(pred_pose: torch.Tensor, pose_mode: str) -> np.ndarray:
    """[n, K, pose_dim] -> [n, K, 4, 4] float64 (ref ``evaluation_single.py:324-332``)."""
    rot, trans = pose_to_rt(pred_pose, pose_mode)
    return rt_to_matrix4(rot, trans).cpu().numpy().astype(np.float64)


def _chunks(num: int, batch_size: int):
    return [(lo, min(lo + batch_size, num)) for lo in range(0, num, batch_size)]


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with copies of its last row appended up to ``rows`` rows."""
    n = x.shape[0]
    return x if n >= rows else torch.cat([x, x[-1:].expand(rows - n, *x.shape[1:])])


def _sharded_call(group, fn, batch, *rows):
    """``fn(batch, *rows)`` over this rank's rows of the padded chunk, the
    outputs gathered from every rank (just ``fn`` without a group)."""
    batch, rows = parallel.shard_batch(group, (batch, rows))
    with parallel.sharded(group):
        out = fn(batch, *rows)
    return parallel.all_gather_rows(group, out)


def inference_pose(cfg: Config, score_agent: PoseAgent, data_path: str,
                   inference_res_dir: str, generator: Optional[torch.Generator] = None,
                   group: Optional[parallel.DPGroup] = None):
    """Stage 2: K-hypothesis score sampling per category chunk
    (ref ``evaluation_single.py:356-425``).  The prior comes from
    ``generator`` (default: one on the agent's device seeded ``cfg.seed``).
    Under ``group`` each chunk is split over the ranks; rank 0 writes."""
    dev = score_agent.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    detect_result, categorized = unpack_data(cfg, data_path)

    for cat, data in categorized.items():
        num = len(data["img_path"])
        data["pred_pose"] = []
        if num == 0:
            continue
        print(f"Inferencing {cat}: {num} instances")
        for lo, hi in _chunks(num, cfg.batch_size):
            batch = {k: pad_rows(v, cfg.batch_size)
                     for k, v in zero_center_batch(data["pts"][lo:hi], dev).items()}
            # sampler from cfg.sampler_mode: "ode" (Heun at cfg.sampling_steps),
            # "ode_adaptive" (RK45 at atol/rtol 1e-5, the reference's solver),
            # "pc" or, under sde_mode "edm", "edm", each at cfg.sampling_steps
            pred = _sharded_call(
                group, lambda b: score_agent.sample(b, generator=generator,
                                                    repeat_num=cfg.eval_repeat_num,
                                                    num_steps=cfg.sampling_steps, T0=cfg.T0),
                batch)[:hi - lo]
            rts = pose_to_rts(pred, cfg.pose_mode)
            data["pred_pose"] += list(pred.cpu().numpy())
            for bi, path in enumerate(data["img_path"][lo:hi]):
                inst = data["inst"][lo + bi]
                detect_result[path]["result"]["multi_hypothesis_pred_RTs"][inst] = rts[bi]

    if group is None or group.is_writer:
        os.makedirs(inference_res_dir, exist_ok=True)
        with open(os.path.join(inference_res_dir, "results_wo_energy.pkl"), "wb") as f:
            pickle.dump(detect_result, f)
        with open(os.path.join(inference_res_dir, "cls_data.pkl"), "wb") as f:
            pickle.dump(categorized, f)
    parallel.barrier(group)


def inference_energy(cfg: Config, energy_agent: PoseAgent, inference_res_dir: str,
                     group: Optional[parallel.DPGroup] = None):
    """Stage 3: energy scoring + decoupled hypothesis sort
    (ref ``evaluation_single.py:428-489``).  Under ``group`` each chunk is
    split over the ranks; rank 0 writes."""
    dev = energy_agent.device
    with open(os.path.join(inference_res_dir, "results_wo_energy.pkl"), "rb") as f:
        detect_result = pickle.load(f)
    with open(os.path.join(inference_res_dir, "cls_data.pkl"), "rb") as f:
        categorized = pickle.load(f)

    for data in categorized.values():
        num = len(data["img_path"])
        for lo, hi in _chunks(num, cfg.batch_size):
            batch = {k: pad_rows(v, cfg.batch_size)
                     for k, v in zero_center_batch(data["pts"][lo:hi], dev).items()}
            pred_pose = pad_rows(torch.as_tensor(np.asarray(data["pred_pose"][lo:hi])).to(dev),
                                 cfg.batch_size)
            energy = _sharded_call(
                group, lambda b, p: energy_agent.get_energy(b, p, T=1e-5), batch, pred_pose)
            sorted_pose, sorted_energy = sort_poses_by_energy(pred_pose, energy)
            rts = pose_to_rts(sorted_pose[:hi - lo], cfg.pose_mode)
            sorted_energy = sorted_energy[:hi - lo].cpu().numpy()
            for bi, path in enumerate(data["img_path"][lo:hi]):
                inst = data["inst"][lo + bi]
                res = detect_result[path]["result"]
                res["multi_hypothesis_pred_RTs"][inst] = rts[bi]
                res["energy"][inst] = sorted_energy[bi]

    if group is None or group.is_writer:
        with open(os.path.join(inference_res_dir, "results_with_energy.pkl"), "wb") as f:
            pickle.dump(detect_result, f)


def record_results_and_draw_curves(cfg, save_path, iou_aps, pose_aps, iou_acc, pose_acc,
                                   iou_thres_list, degree_thres_list, shift_thres_list):
    """Headline-number logs + curves (ref ``evaluation_single.py:62-102``)."""
    plot_mAP(iou_aps, pose_aps, save_path["inference_res_dir"], iou_thres_list,
             degree_thres_list, shift_thres_list,
             f"{save_path['pooling_mode']}_ratio_{save_path['ratio']}_mAP.png")
    d05 = degree_thres_list.index(5)
    d10 = degree_thres_list.index(10)
    s02 = shift_thres_list.index(2)
    s05 = shift_thres_list.index(5)
    headline = {}
    for i in range(1, 8):
        cls_name = "mean" if i == 7 else cfg.synset_names[i - 1]
        messages = [
            f"cls_name: {cls_name}",
            f"{save_path['pooling_mode']}_ratio_{save_path['ratio']}",
            "mAP:",
            "5 degree, 2cm: {:.1f}".format(pose_aps[i, d05, s02] * 100),
            "5 degree, 5cm: {:.1f}".format(pose_aps[i, d05, s05] * 100),
            "10 degree, 2cm: {:.1f}".format(pose_aps[i, d10, s02] * 100),
            "10 degree, 5cm: {:.1f}".format(pose_aps[i, d10, s05] * 100),
            "Acc:",
            "5 degree, 2cm: {:.1f}".format(pose_acc[i, d05, s02] * 100),
            "5 degree, 5cm: {:.1f}".format(pose_acc[i, d05, s05] * 100),
            "10 degree, 2cm: {:.1f}".format(pose_acc[i, d10, s02] * 100),
            "10 degree, 5cm: {:.1f}".format(pose_acc[i, d10, s05] * 100),
        ]
        log = "eval_logs.txt" if i == 7 else "eval_logs_single_cls.txt"
        with open(os.path.join(save_path["inference_res_dir"], log), "a") as fw:
            for msg in messages:
                print(msg)
                fw.write(msg + "\n")
        if i == 7:
            headline = {
                "5d2cm": pose_aps[i, d05, s02] * 100,
                "5d5cm": pose_aps[i, d05, s05] * 100,
                "10d2cm": pose_aps[i, d10, s02] * 100,
                "10d5cm": pose_aps[i, d10, s05] * 100,
            }
    return headline


def evaluate(cfg: Config, inference_res_dir: str, file_name: str = "results_with_energy.pkl"):
    """Stage 4: NOCS mAP (ref ``evaluation_single.py:492-544``).  Returns the
    headline of the last ratio in ``cfg.eval_ratios``."""
    degree_thres_list = list(range(0, 46, 1))
    shift_thres_list = [i / 2 for i in range(21)]
    iou_thres_list = [i / 100 for i in range(101)]

    with open(os.path.join(inference_res_dir, file_name), "rb") as f:
        predictions = pickle.load(f)

    pred_results = []
    for entry in predictions.values():
        result = entry["result"]
        if "gt_handle_visibility" not in result:
            result["gt_handle_visibility"] = np.ones_like(result["gt_class_ids"])
        pred_results.append(result)

    save_path = {
        "inference_res_dir": os.path.join(inference_res_dir, "results", cfg.pooling_mode,
                                          cfg.ranker),
        "ratio": 0,
        "pooling_mode": cfg.pooling_mode,
    }
    os.makedirs(save_path["inference_res_dir"], exist_ok=True)

    headline = None
    for ratio in (float(r) for r in cfg.eval_ratios):
        print(f"pooling_mode: {cfg.pooling_mode}, ranker: {cfg.ranker}, ratio: {ratio}")
        iou_aps, pose_aps, iou_acc, pose_acc = compute_mAP(
            pred_results, save_path["inference_res_dir"], degree_thres_list,
            shift_thres_list, iou_thres_list, iou_pose_thres=0.1,
            use_matches_for_pose=True, repeat_num=cfg.eval_repeat_num,
            pooling_mode=cfg.pooling_mode, ratio=ratio, ranker=cfg.ranker)
        save_path["ratio"] = ratio
        headline = record_results_and_draw_curves(
            cfg, save_path, iou_aps, pose_aps, iou_acc, pose_acc,
            iou_thres_list, degree_thres_list, shift_thres_list)
    return headline


def write_headline(inference_res_dir: str, headline: dict) -> str:
    """``mAP_headline.json``: the mean-class mAP at the paper's four
    thresholds, in percent."""
    path = os.path.join(inference_res_dir, "mAP_headline.json")
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in headline.items()}, f, indent=1)
    print("headline mAP:", {k: round(float(v), 1) for k, v in headline.items()})
    return path


def load_agent(cfg: Config, mode: str, model_dir: str, device) -> PoseAgent:
    """An agent with the weights of the port's checkpoint under
    ``results/ckpts/<model_dir>`` (a ``ckpt_epochN`` file, or the newest one
    in that directory); seeded weights when ``model_dir`` is empty."""
    agent = PoseAgent(cfg, mode, device=device)
    if model_dir:
        path = os.path.join("results", "ckpts", model_dir)
        if os.path.isdir(path):
            path = latest_checkpoint(path)
            if path is None:
                raise FileNotFoundError(f"no ckpt_epochN under results/ckpts/{model_dir}")
        load_checkpoint(path, agent, load_model_only=True)
    return agent


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg = get_config(argv)
    device = runner_device(cfg)
    if torch.distributed.is_initialized() or "WORLD_SIZE" in os.environ:
        return _group_main(parallel.make_group(cfg.num_devices, device), argv)
    n_dev = parallel.resolve_num_devices(cfg.num_devices, device)
    if n_dev > 1 and cfg.batch_size % n_dev == 0:
        print(f"Sharding eval batches over {n_dev} devices")
        return parallel.launch(_group_main, n_dev, device, args=(argv,))[0]
    return _main(cfg, device, None)


def _group_main(group: parallel.DPGroup, argv):
    """One rank's evaluation (``main``'s workers, or a ``torchrun`` process):
    sharded when ``batch_size`` divides over the group, else rank 0 alone
    runs it unsharded."""
    cfg = get_config(argv)
    if cfg.batch_size % group.world == 0:
        return _main(cfg, group.device, group)
    return _main(cfg, group.device, None) if group.is_writer else None


def _main(cfg: Config, device, group: Optional[parallel.DPGroup]):
    writer = group is None or group.is_writer
    inference_res_root = os.path.join(cfg.result_dir, "evaluation_results")
    inference_res_dir = os.path.join(inference_res_root,
                                     f"{cfg.test_source}_repeat_{cfg.eval_repeat_num}")
    seg_path = os.path.join(inference_res_root, f"segmentation_results_{cfg.test_source}.pkl")

    print("Detecting ...")
    if writer:
        detect_mrcnn_results(cfg, seg_path)
    parallel.barrier(group)

    # the weights are pinned for the whole evaluation: freeze each agent (on a
    # card, CUDA graphs of its padded chunk, or of this rank's rows of it), as
    # the JAX runner's main does
    print("Predict pose ...")
    score_agent = load_agent(cfg, "score", cfg.score_model_dir, device).freeze()
    inference_pose(cfg, score_agent, seg_path, inference_res_dir, group=group)

    print("Predict energy ...")
    energy_agent = load_agent(cfg, "energy", cfg.energy_model_dir, device).freeze()
    inference_energy(cfg, energy_agent, inference_res_dir, group=group)
    if not writer:
        return None

    print("Evaluating ...")
    headline = evaluate(cfg, inference_res_dir, "results_with_energy.pkl")
    if headline:
        write_headline(inference_res_dir, headline)
    return headline


if __name__ == "__main__":
    main()
