"""NOCS-style mAP evaluation with multi-hypothesis ranking and pooling
(counterpart of ``genpose_tpu/eval/nocs_eval.py``).

The reference's adapted NOCS protocol (``utils/sgpa_utils.py``), on the host:

- 3D IoU with a 20-step y-rotation sweep for symmetric classes
  (``sgpa_utils.py:328-371``), keeping the per-corner ``amax`` quirk;
- greedy score-ordered 2D-IoU matching against GT (``:470-527``);
- per-class hypothesis ranking (energy / gt / random rankers), top-ratio
  selection, and 'average' (quaternion pooling) or 'nearest' (min-error)
  pooling (``:829-954``);
- RT matching over degree x shift threshold grids (``:589-624``);
- VOC-style AP integration (``:627-649``);
- ``compute_mAP`` over scene results (``:957-1197``) and the mAP curve plot
  (``:1200-1251``).

The quaternion pooling goes through the port's ``ops/pose.py`` on CPU
float32 tensors, as the JAX package pools through ``jnp`` at float32: a
float64 pooling would move an error across a threshold now and then.
Everything else is numpy in float64, copied from the JAX package.

Class ids here are 1-based and ``synset_names`` starts with 'BG'
(``sgpa_utils.py:969``), unlike the 0-based training metrics.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np
import torch

from genpose_tpu_torch.eval.metrics import compute_RT_errors
from genpose_tpu_torch.ops.pose import (
    average_quaternion_batch,
    matrix_to_quat_wxyz,
    quat_wxyz_to_matrix,
)

SYNSET_NAMES_BG = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def get_3d_bbox(size, shift=0) -> np.ndarray:
    """8 corners of an axis-aligned box, [3, 8] (ref ``sgpa_utils.py:290-308``)."""
    s = np.asarray(size, dtype=np.float64)
    signs = np.array([
        [+1, +1, +1], [+1, +1, -1], [-1, +1, +1], [-1, +1, -1],
        [+1, -1, +1], [+1, -1, -1], [-1, -1, +1], [-1, -1, -1],
    ])
    corners = signs * (s / 2.0) + shift
    return corners.T


def transform_coordinates_3d(coordinates: np.ndarray, sRT: np.ndarray) -> np.ndarray:
    """Apply a homogeneous transform to [3, N] points (ref ``:311-325``)."""
    assert coordinates.shape[0] == 3
    homo = np.vstack([coordinates, np.ones((1, coordinates.shape[1]))])
    out = sRT @ homo
    return out[:3, :] / out[3, :]


def compute_3d_IoU(sRT_1, sRT_2, size_1, size_2, class_name_1, class_name_2,
                   handle_visibility) -> float:
    """3D bbox "IoU"; symmetric classes sweep 20 y-rotations of the prediction
    (ref ``sgpa_utils.py:328-371``).

    PROTOCOL QUIRK kept deliberately: the reference (and the upstream NOCS
    code it adapts) reduces corner sets of shape [3, 8] with
    ``np.amax(..., axis=0)`` — per-CORNER maxima over the three coordinates
    rather than per-coordinate extents.  All published NOCS-protocol numbers
    use this arithmetic, so bit-parity requires it."""
    if sRT_1 is None or sRT_2 is None:
        return -1.0

    def iou(rt1):
        c1 = transform_coordinates_3d(get_3d_bbox(size_1, 0), rt1)
        c2 = transform_coordinates_3d(get_3d_bbox(size_2, 0), sRT_2)
        b1_max = np.amax(c1, axis=0)
        b1_min = np.amin(c1, axis=0)
        b2_max = np.amax(c2, axis=0)
        b2_min = np.amin(c2, axis=0)
        lo = np.maximum(b1_min, b2_min)
        hi = np.minimum(b1_max, b2_max)
        if np.amin(hi - lo) < 0:
            inter = 0.0
        else:
            inter = np.prod(hi - lo)
        union = np.prod(b1_max - b1_min) + np.prod(b2_max - b2_min) - inter
        return inter / union

    symmetric = (
        class_name_1 in ("bottle", "bowl", "can") and class_name_1 == class_name_2
    ) or (class_name_1 == "mug" and class_name_1 == class_name_2
          and handle_visibility == 0)
    if symmetric:
        n = 20
        best = 0.0
        for i in range(n):
            theta = 2 * np.pi * i / n
            ry = np.array([
                [np.cos(theta), 0, np.sin(theta), 0],
                [0, 1, 0, 0],
                [-np.sin(theta), 0, np.cos(theta), 0],
                [0, 0, 0, 1],
            ])
            best = max(best, iou(sRT_1 @ ry))
        return best
    return iou(sRT_1)


# ---------------------------------------------------------------------------
# matching (greedy, protocol-order-dependent)
# ---------------------------------------------------------------------------

def _greedy_match(overlaps: np.ndarray, thresholds: Sequence[float],
                  pred_class_ids, gt_class_ids, score_threshold=0):
    """Score-ordered greedy matching shared by the 2D/3D IoU protocols
    (ref ``sgpa_utils.py:405-434``).  ``overlaps`` rows are already in
    score-descending order."""
    num_pred, num_gt = overlaps.shape
    n_thres = len(thresholds)
    pred_matches = -1 * np.ones((n_thres, num_pred))
    gt_matches = -1 * np.ones((n_thres, num_gt))
    # each prediction's overlap-sorted GT candidates are threshold-
    # independent: sort once, trim below score_threshold up front (the
    # reference's "remove low scores" step, ``sgpa_utils.py:414-418``)
    orders = []
    for i in range(num_pred):
        order = np.argsort(overlaps[i])[::-1]
        low = np.where(overlaps[i, order] < score_threshold)[0]
        if low.size > 0:
            order = order[: low[0]]
        orders.append(order)
    for s, thres in enumerate(thresholds):
        for i in range(num_pred):
            for j in orders[i]:
                if gt_matches[s, j] > -1:
                    continue
                if overlaps[i, j] < thres:
                    break
                if pred_class_ids[i] != gt_class_ids[j]:
                    continue
                if overlaps[i, j] > thres:
                    gt_matches[s, j] = i
                    pred_matches[s, i] = j
                    break
    return gt_matches, pred_matches


def compute_IoU_matches(gt_class_ids, gt_sRT, gt_size, gt_handle_visibility,
                        pred_class_ids, pred_sRT, pred_size, pred_scores,
                        synset_names, iou_3d_thresholds, score_threshold=0):
    """3D-IoU GT matching (ref ``sgpa_utils.py:374-434``)."""
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    indices = np.zeros(0, dtype=int)
    if num_pred:
        indices = np.argsort(pred_scores)[::-1]
        pred_class_ids = np.asarray(pred_class_ids)[indices]
        pred_size = np.asarray(pred_size)[indices]
        pred_sRT = np.asarray(pred_sRT)[indices]
    overlaps = np.zeros((num_pred, num_gt), dtype=np.float32)
    for i in range(num_pred):
        for j in range(num_gt):
            overlaps[i, j] = compute_3d_IoU(
                pred_sRT[i], gt_sRT[j], pred_size[i], gt_size[j],
                synset_names[int(pred_class_ids[i])],
                synset_names[int(gt_class_ids[j])], gt_handle_visibility[j],
            )
    gt_matches, pred_matches = _greedy_match(
        overlaps, iou_3d_thresholds, pred_class_ids, gt_class_ids,
        score_threshold)
    return gt_matches, pred_matches, overlaps, indices


def compute_2d_IoU(bbox1, bbox2) -> float:
    """2D bbox IoU with inclusive pixel counting (ref ``sgpa_utils.py:437-467``)."""
    x1 = max(bbox1[0], bbox2[0])
    y1 = max(bbox1[1], bbox2[1])
    x2 = min(bbox1[2], bbox2[2])
    y2 = min(bbox1[3], bbox2[3])
    inter = max(0, x2 - x1 + 1) * max(0, y2 - y1 + 1)
    a1 = (bbox1[2] - bbox1[0] + 1) * (bbox1[3] - bbox1[1] + 1)
    a2 = (bbox2[2] - bbox2[0] + 1) * (bbox2[3] - bbox2[1] + 1)
    return inter / (a1 + a2 - inter)


def compute_2d_IoU_matches(gt_class_ids, gt_bboxes, pred_class_ids, pred_bboxes,
                           pred_scores, iou_2d_thresholds, score_threshold=0):
    """2D-IoU GT matching (ref ``sgpa_utils.py:470-527``)."""
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    indices = np.zeros(0, dtype=int)
    if num_pred:
        indices = np.argsort(pred_scores)[::-1]
        pred_class_ids = np.asarray(pred_class_ids)[indices]
        pred_bboxes = np.asarray(pred_bboxes)[indices]
    overlaps = np.zeros((num_pred, num_gt), dtype=np.float32)
    for i in range(num_pred):
        for j in range(num_gt):
            overlaps[i, j] = compute_2d_IoU(pred_bboxes[i], gt_bboxes[j])
    gt_matches, pred_matches = _greedy_match(
        overlaps, iou_2d_thresholds, pred_class_ids, gt_class_ids,
        score_threshold)
    return gt_matches, pred_matches, overlaps, indices


def compute_RT_overlaps(gt_class_ids, gt_sRT, gt_handle_visibility,
                        pred_class_ids, pred_sRT, synset_names) -> np.ndarray:
    """Pairwise (deg, cm) error grid [num_pred, num_gt, 2]
    (ref ``sgpa_utils.py:572-586``)."""
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    overlaps = np.zeros((num_pred, num_gt, 2))
    for i in range(num_pred):
        for j in range(num_gt):
            overlaps[i, j, :] = compute_RT_errors(
                pred_sRT[i], gt_sRT[j], int(gt_class_ids[j]),
                gt_handle_visibility[j], synset_names,
            )
    return overlaps


def compute_RT_matches(overlaps, pred_class_ids, gt_class_ids,
                       degree_thres_list, shift_thres_list):
    """Greedy matching over the degree x shift grid (ref ``sgpa_utils.py:589-624``)."""
    nd, ns = len(degree_thres_list), len(shift_thres_list)
    num_pred, num_gt = len(pred_class_ids), len(gt_class_ids)
    pred_matches = -1 * np.ones((nd, ns, num_pred))
    gt_matches = -1 * np.ones((nd, ns, num_gt))
    if num_pred == 0 or num_gt == 0:
        return gt_matches, pred_matches

    sum_err = overlaps.sum(axis=-1)  # [num_pred, num_gt]
    orders = np.argsort(sum_err, axis=-1)
    for d, deg_t in enumerate(degree_thres_list):
        for s, shift_t in enumerate(shift_thres_list):
            for i in range(num_pred):
                for j in orders[i]:
                    if gt_matches[d, s, j] > -1 or pred_class_ids[i] != gt_class_ids[j]:
                        continue
                    if overlaps[i, j, 0] > deg_t or overlaps[i, j, 1] > shift_t:
                        continue
                    gt_matches[d, s, j] = i
                    pred_matches[d, s, i] = j
                    break
    return gt_matches, pred_matches


def compute_ap_and_acc(pred_matches, pred_scores, gt_matches):
    """VOC AP + accuracy (ref ``sgpa_utils.py:627-649``)."""
    assert pred_matches.shape[0] == pred_scores.shape[0]
    order = np.argsort(pred_scores)[::-1]
    pred_matches = pred_matches[order]
    hits = np.cumsum(pred_matches > -1)
    precisions = hits / (np.arange(len(pred_matches)) + 1)
    recalls = hits.astype(np.float32) / len(gt_matches)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    ap = np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx])
    # empty-class 0/0 -> nan, exactly like the reference (sgpa_utils.py:647);
    # absent classes must read "nan" in eval_logs_single_cls.txt, not 0.0
    with np.errstate(invalid="ignore"):
        acc = np.float64(np.sum(pred_matches > -1)) / len(pred_matches) \
            if len(pred_matches) else np.float64("nan")
    return ap, acc


# ---------------------------------------------------------------------------
# hypothesis ranking + pooling
# ---------------------------------------------------------------------------

def _f32(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU float32 tensor, as ``jnp.asarray`` makes it."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _srt_to_quat_t(sRT: np.ndarray) -> np.ndarray:
    """[N, 4, 4] -> [N, 7] (wxyz quat + t); the quaternion in float32."""
    q = matrix_to_quat_wxyz(_f32(sRT[:, :3, :3])).numpy()
    return np.concatenate([q, sRT[:, :3, 3]], axis=-1)


def _quat_t_average(quat_t: np.ndarray) -> np.ndarray:
    """[N, K, 7] -> averaged [N, 4, 4] via quaternion eigen-averaging (float32)."""
    N = quat_t.shape[0]
    avg_q = average_quaternion_batch(_f32(quat_t[..., :4]))
    avg_t = quat_t[..., 4:].mean(axis=1)
    out = np.tile(np.eye(4), (N, 1, 1))
    out[:, :3, :3] = quat_wxyz_to_matrix(avg_q).numpy()
    out[:, :3, 3] = avg_t
    return out


def sort_sRT(poses: np.ndarray, energy: np.ndarray):
    """Decoupled descending-energy sort of 4x4 hypotheses
    (ref ``sgpa_utils.py:24-51``): rotation/scale rows follow the
    rot-energy order, the translation column follows the trans-energy order."""
    order = np.argsort(-energy, axis=1)  # [N, K, 2]
    sorted_energy = np.take_along_axis(energy, order, axis=1)
    rot_order = order[..., 0]
    trans_order = order[..., 1]
    sorted_poses = np.take_along_axis(poses, rot_order[..., None, None], axis=1)
    trans_sorted = np.take_along_axis(poses, trans_order[..., None, None], axis=1)
    sorted_poses[:, :, :, 3] = trans_sorted[:, :, :, 3]
    return sorted_poses, sorted_energy


def sort_sRT_by_energy(sRT, energy=None, RT_overlaps=None,
                       ranker="energy_ranker", ratio=1.0, error_mode="average"):
    """Rank hypotheses, keep top ``ratio``, optionally quaternion-average
    (ref ``sgpa_utils.py:897-954``)."""
    pred_num, repeat_num = sRT.shape[0], sRT.shape[1]
    selected_num = max(1, int(repeat_num * ratio))
    if pred_num == 0:
        return sRT[:, :selected_num], None, None

    if ranker == "energy_ranker":
        RT_energy = energy
    elif ranker == "gt_ranker":
        if RT_overlaps.shape[1] == 0:
            # no GT instance of this class in the scene (false-positive
            # detections): there is no GT error to rank by, so keep the
            # incoming hypothesis order (strictly decreasing pseudo-energy;
            # the reference crashes here on a zero-size np.min,
            # ``sgpa_utils.py:938-939``)
            RT_energy = np.broadcast_to(
                -np.arange(repeat_num, dtype=np.float64)[None, :, None],
                (pred_num, repeat_num, 2)).copy()
        else:
            # higher energy = lower GT error (min over gt instances)
            RT_energy = -np.min(RT_overlaps, axis=1)
    elif ranker == "random":
        RT_energy = np.random.rand(pred_num, repeat_num, 2)
    else:
        raise NotImplementedError(ranker)

    sorted_sRT, sorted_energy = sort_sRT(sRT, RT_energy)
    selected_sRT = sorted_sRT[:, :selected_num]
    selected_energy = sorted_energy[:, :selected_num]

    if error_mode == "average":
        quat_t = _srt_to_quat_t(selected_sRT.reshape(-1, 4, 4)).reshape(
            pred_num, selected_num, 7)
        average_sRT = _quat_t_average(quat_t)
        return selected_sRT, average_sRT, selected_energy
    if error_mode == "nearest":
        return selected_sRT, None, selected_energy
    raise NotImplementedError(error_mode)


# ---------------------------------------------------------------------------
# the mAP computation
# ---------------------------------------------------------------------------

class _ApAccumulator:
    """Per-class growing buffers of matches/scores (replaces the reference's
    preallocated 30000-column arrays, ``sgpa_utils.py:984-996``)."""

    def __init__(self, num_classes: int, lead_shape):
        self.pred_matches = [[] for _ in range(num_classes)]
        self.pred_scores = [[] for _ in range(num_classes)]
        self.gt_matches = [[] for _ in range(num_classes)]
        self.lead_shape = lead_shape

    def add(self, cls_id, pred_match, scores_tile, gt_match):
        self.pred_matches[cls_id].append(pred_match)
        self.pred_scores[cls_id].append(scores_tile)
        self.gt_matches[cls_id].append(gt_match)

    def collect(self, cls_id):
        cat = lambda lst: (
            np.concatenate(lst, axis=-1) if lst
            else np.zeros(self.lead_shape + (0,))
        )
        return (cat(self.pred_matches[cls_id]), cat(self.pred_scores[cls_id]),
                cat(self.gt_matches[cls_id]))


def compute_mAP(pred_results, out_dir, degree_thresholds=(180,),
                shift_thresholds=(100,), iou_3d_thresholds=(0.1,),
                iou_pose_thres=0.1, use_matches_for_pose=False,
                repeat_num=None, pooling_mode="average", ratio=1.0,
                ranker="energy_ranker", synset_names=None):
    """Multi-hypothesis NOCS mAP (ref ``sgpa_utils.py:957-1197``).

    pred_results: list of per-scene dicts with keys gt_class_ids / gt_RTs /
    gt_scales / gt_handle_visibility / gt_bboxes / pred_class_ids /
    multi_hypothesis_pred_RTs [P, K, 4, 4] / energy [P, K, 2] / pred_scales /
    pred_scores / pred_bboxes.
    Returns (iou_aps, pose_aps, iou_acc, pose_acc) with the reference's
    [num_classes+1, ...] layout (last row = class mean).
    """
    synset_names = list(synset_names or SYNSET_NAMES_BG)
    num_classes = len(synset_names)
    degree_thres_list = list(degree_thresholds) + [360]
    shift_thres_list = list(shift_thresholds) + [100]
    iou_thres_list = list(iou_3d_thresholds)
    nd, ns, ni = len(degree_thres_list), len(shift_thres_list), len(iou_thres_list)

    if use_matches_for_pose:
        assert iou_pose_thres in iou_thres_list

    iou_acc_buf = _ApAccumulator(num_classes, (ni,))
    pose_acc_buf = _ApAccumulator(num_classes, (nd, ns))

    for result in pred_results:
        gt_class_ids = np.asarray(result["gt_class_ids"]).astype(np.int32)
        gt_sRT = np.array(result["gt_RTs"])
        gt_handle_visibility = np.asarray(result["gt_handle_visibility"])
        gt_bboxes = np.array(result["gt_bboxes"])

        pred_class_ids = np.asarray(result["pred_class_ids"])
        multi_sRT = np.asarray(result["multi_hypothesis_pred_RTs"])
        pred_energy = np.asarray(result["energy"])
        pred_scores = np.asarray(result["pred_scores"])
        pred_bboxes = np.array(result["pred_bboxes"])
        K = multi_sRT.shape[1] if multi_sRT.ndim >= 2 else (repeat_num or 1)

        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in range(1, num_classes):
            g_sel = gt_class_ids == cls_id
            cls_gt_ids = gt_class_ids[g_sel] if len(gt_class_ids) else np.zeros(0)
            cls_gt_sRT = gt_sRT[g_sel] if len(gt_class_ids) else np.zeros((0, 4, 4))
            cls_gt_bboxes = gt_bboxes[g_sel] if len(gt_class_ids) else np.zeros((0, 4))
            if synset_names[cls_id] != "mug":
                cls_gt_hv = np.ones_like(cls_gt_ids)
            else:
                cls_gt_hv = (gt_handle_visibility[g_sel] if len(gt_class_ids)
                             else np.ones(0))

            p_sel = pred_class_ids == cls_id
            cls_pred_ids = pred_class_ids[p_sel] if len(pred_class_ids) else np.zeros(0)
            cls_multi_sRT = (multi_sRT[p_sel] if len(pred_class_ids)
                             else np.zeros((0, K, 4, 4)))
            cls_energy = (pred_energy[p_sel] if len(pred_class_ids)
                          else np.zeros((0, K, 2)))
            cls_scores = pred_scores[p_sel] if len(pred_class_ids) else np.zeros(0)
            cls_bboxes = (pred_bboxes[p_sel] if len(pred_class_ids)
                          else np.zeros((0, 4)))

            # detection matching: 2D IoU vs GT (ref :1046-1049)
            iou_gt_match, iou_pred_match, _, iou_indices = compute_2d_IoU_matches(
                cls_gt_ids, cls_gt_bboxes, cls_pred_ids, cls_bboxes, cls_scores,
                iou_thres_list,
            )
            if len(iou_indices):
                cls_pred_ids = cls_pred_ids[iou_indices]
                cls_multi_sRT = cls_multi_sRT[iou_indices]
                cls_energy = cls_energy[iou_indices]
                cls_scores = cls_scores[iou_indices]

            scores_tile = np.tile(cls_scores, (ni, 1))
            iou_acc_buf.add(cls_id, iou_pred_match, scores_tile, iou_gt_match)

            if use_matches_for_pose:
                ti = iou_thres_list.index(iou_pose_thres)
                pm = iou_pred_match[ti, :]
                keep_p = pm > -1
                cls_pred_ids = cls_pred_ids[keep_p] if len(pm) else np.zeros(0)
                cls_multi_sRT = (cls_multi_sRT[keep_p] if len(pm)
                                 else np.zeros((0, K, 4, 4)))
                cls_energy = (cls_energy[keep_p] if len(pm)
                              else np.zeros((0, K, 2)))
                cls_scores = cls_scores[keep_p] if len(pm) else np.zeros(0)
                gm = iou_gt_match[ti, :]
                keep_g = gm > -1
                cls_gt_ids = cls_gt_ids[keep_g] if len(gm) else np.zeros(0)
                cls_gt_sRT = cls_gt_sRT[keep_g] if len(gm) else np.zeros((0, 4, 4))
                cls_gt_hv = cls_gt_hv[keep_g] if len(gm) else np.zeros(0)

            # gt_ranker needs per-hypothesis overlaps (ref :1096-1104)
            cls_multi_overlaps = None
            if ranker == "gt_ranker":
                per_hyp = [
                    compute_RT_overlaps(cls_gt_ids, cls_gt_sRT, cls_gt_hv,
                                        cls_pred_ids, cls_multi_sRT[:, k],
                                        synset_names)
                    for k in range(cls_multi_sRT.shape[1])
                ]
                cls_multi_overlaps = np.array(per_hyp).transpose(1, 2, 0, 3)

            if pooling_mode == "nearest":
                sorted_sRT_sel, _, _ = sort_sRT_by_energy(
                    cls_multi_sRT, cls_energy, cls_multi_overlaps, ranker,
                    ratio, "nearest")
                per_hyp = [
                    compute_RT_overlaps(cls_gt_ids, cls_gt_sRT, cls_gt_hv,
                                        cls_pred_ids, sorted_sRT_sel[:, k],
                                        synset_names)
                    for k in range(sorted_sRT_sel.shape[1])
                ]
                RT_overlaps = np.min(np.array(per_hyp), axis=0)
            elif pooling_mode == "average":
                _, average_sRT, _ = sort_sRT_by_energy(
                    cls_multi_sRT, cls_energy, cls_multi_overlaps, ranker,
                    ratio, "average")
                if average_sRT is None:
                    average_sRT = np.zeros((0, 4, 4))
                RT_overlaps = compute_RT_overlaps(
                    cls_gt_ids, cls_gt_sRT, cls_gt_hv, cls_pred_ids,
                    average_sRT, synset_names)
            else:
                raise NotImplementedError(pooling_mode)

            pose_gt_match, pose_pred_match = compute_RT_matches(
                RT_overlaps, cls_pred_ids, cls_gt_ids, degree_thres_list,
                shift_thres_list)
            scores_tile = np.tile(cls_scores, (nd, ns, 1))
            pose_acc_buf.add(cls_id, pose_pred_match, scores_tile, pose_gt_match)

    # AP integration (ref :1164-1183)
    iou_aps = np.zeros((num_classes + 1, ni))
    iou_acc = np.zeros((num_classes + 1, ni))
    pose_aps = np.zeros((num_classes + 1, nd, ns))
    pose_acc = np.zeros((num_classes + 1, nd, ns))
    for cls_id in range(1, num_classes):
        pm, ps, gm = iou_acc_buf.collect(cls_id)
        for s in range(ni):
            iou_aps[cls_id, s], iou_acc[cls_id, s] = compute_ap_and_acc(
                pm[s], ps[s], gm[s])
        pm, ps, gm = pose_acc_buf.collect(cls_id)
        for i in range(nd):
            for j in range(ns):
                pose_aps[cls_id, i, j], pose_acc[cls_id, i, j] = \
                    compute_ap_and_acc(pm[i, j], ps[i, j], gm[i, j])
    iou_aps[-1] = np.mean(iou_aps[1:-1], axis=0)
    iou_acc[-1] = np.mean(iou_acc[1:-1], axis=0)
    pose_aps[-1] = np.mean(pose_aps[1:-1], axis=0)
    pose_acc[-1] = np.mean(pose_acc[1:-1], axis=0)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "mAP_Acc.pkl"), "wb") as f:
            pickle.dump({
                "iou_thres_list": iou_thres_list,
                "degree_thres_list": degree_thres_list,
                "shift_thres_list": shift_thres_list,
                "iou_aps": iou_aps, "pose_aps": pose_aps,
                "iou_acc": iou_acc, "pose_acc": pose_acc,
            }, f)
    return iou_aps, pose_aps, iou_acc, pose_acc


def plot_mAP(iou_aps, pose_aps, out_dir, iou_thres_list, degree_thres_list,
             shift_thres_list, out_name="mAP.png"):
    """mAP curves (ref ``sgpa_utils.py:1200-1251``), drawn when matplotlib
    imports; otherwise one line says so and None is returned.  Nothing else
    of the evaluation depends on the curve."""
    try:
        import matplotlib
    except ImportError:
        print(f"mAP curve {out_name} not drawn: matplotlib is not installed", flush=True)
        return None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = ["bottle", "bowl", "camera", "can", "laptop", "mug", "mean", "nocs"]
    colors = ["tab:blue", "tab:orange", "tab:green", "tab:pink", "tab:olive",
              "tab:purple", "tab:red", "tab:gray"]
    styles = ["-", "-", "-", "-", "-", "-", "--", ":"]

    fig, (ax_iou, ax_deg, ax_shift) = plt.subplots(1, 3, figsize=(8, 3.5))
    ax_iou.set_title("3D IoU", fontsize=10)
    ax_iou.set_ylabel("Average Precision")
    ax_iou.set_ylim(0, 100)
    ax_iou.set_xlabel("Percent")
    ax_iou.set_xlim(0, 100)
    ax_iou.grid()
    for i in range(1, iou_aps.shape[0]):
        ax_iou.plot(100 * np.array(iou_thres_list), 100 * iou_aps[i],
                    color=colors[(i - 1) % len(colors)],
                    linestyle=styles[(i - 1) % len(styles)],
                    label=labels[(i - 1) % len(labels)])
    ax_deg.set_title("Rotation", fontsize=10)
    ax_deg.set_ylim(0, 100)
    ax_deg.set_xlabel("Degree")
    ax_deg.set_xlim(0, 10)
    ax_deg.grid()
    for i in range(1, pose_aps.shape[0]):
        ax_deg.plot(np.array(degree_thres_list),
                    100 * pose_aps[i, :len(degree_thres_list), -1],
                    color=colors[(i - 1) % len(colors)],
                    linestyle=styles[(i - 1) % len(styles)])
    ax_shift.set_title("Translation", fontsize=10)
    ax_shift.set_ylim(0, 100)
    ax_shift.set_xlabel("Centimeter")
    ax_shift.set_xlim(0, 6)
    ax_shift.grid()
    for i in range(1, pose_aps.shape[0]):
        ax_shift.plot(np.array(shift_thres_list),
                      100 * pose_aps[i, -1, :len(shift_thres_list)],
                      color=colors[(i - 1) % len(colors)],
                      linestyle=styles[(i - 1) % len(styles)],
                      label=labels[(i - 1) % len(labels)])
    ax_shift.legend(loc="lower right", fontsize="small")
    plt.tight_layout()
    path = os.path.join(out_dir, out_name)
    plt.savefig(path, dpi=600)
    plt.close(fig)
    return path
