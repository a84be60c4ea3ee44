"""Synthetic NOCS data (counterpart of ``genpose_tpu/data/synthetic.py``).

- ``synthetic_batch`` makes a raw, pre-``process_batch`` batch of object
  clouds with consistent pose geometry: points on the faces of random boxes
  (NOCS-normalised models), scaled, rotated and placed 0.8-1.4 m in front
  of the camera, with the per-category FS-Net scale residuals and symmetry
  descriptors of the NOCS loader (``data/nocs.py``).
- ``make_synthetic_nocs_dir`` writes a miniature NOCS tree (CAMERA/Real
  lists, ``*_color/_depth/_mask.png``, ``*_label.pkl``, ``obj_models``,
  ``mug_handle.pkl``) of scenes drawn by ``render_scene``, and
  ``make_synthetic_mrcnn_results`` fabricates Mask R-CNN detection pkls
  from its labels (flat, or the tracking layout), so that the evaluation
  and tracking runners can be driven without the real dataset.

Numpy only, copied from the JAX package: the same seed or
``np.random.Generator`` state gives the same arrays, and the same tree (its
PNGs are written and read by ``utils/png.py``, not cv2).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from genpose_tpu_torch.data.nocs import (
    CAMERA_INTRINSICS,
    CAT_NAMES,
    REAL_INTRINSICS,
    get_fs_net_scale,
    get_sym_info,
)
from genpose_tpu_torch.utils import png


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diagonal(r))
    if np.linalg.det(q) < 0:
        q[:, 2] *= -1
    return q.astype(np.float32)


def _box_model(rng: np.random.Generator, n: int = 1024) -> np.ndarray:
    """Random points on a unit-diagonal box surface (NOCS-normalized)."""
    half = rng.uniform(0.2, 0.5, size=3)
    half = half / (2 * np.linalg.norm(half))  # diagonal-normalized
    pts = rng.uniform(-1, 1, size=(n, 3)) * half
    face = rng.integers(0, 3, size=n)
    signs = rng.choice([-1.0, 1.0], size=n)
    pts[np.arange(n), face] = half[face] * signs
    return pts.astype(np.float32)


def render_scene(rng: np.random.Generator, models: Dict[str, np.ndarray], model_names,
                 intrinsics: np.ndarray, im_hw=(480, 640), n_instances: int = 2):
    """Point-splat a few posed objects into (rgb, depth_mm, mask, gts)."""
    H, W = im_hw
    rgb = np.full((H, W, 3), 255, np.uint8)
    depth = np.zeros((H, W), np.float32)
    mask = np.zeros((H, W), np.uint8)
    fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]

    gts = {"class_ids": [], "instance_ids": [], "model_list": [], "scales": [],
           "rotations": [], "translations": [], "bboxes": [],
           "handle_visibility": [], "poses": [], "size": []}

    for inst in range(1, n_instances + 1):
        name = model_names[rng.integers(0, len(model_names))]
        model = models[name]
        cls_id = int(rng.integers(1, len(CAT_NAMES) + 1))
        scale = float(rng.uniform(0.15, 0.3))
        R = _random_rotation(rng)
        t = np.array([
            rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(0.8, 1.4)
        ], np.float32)

        cam_pts = scale * model @ R.T + t  # [N, 3] meters
        z = cam_pts[:, 2]
        u = np.round(cam_pts[:, 0] * fx / z + cx).astype(int)
        v = np.round(cam_pts[:, 1] * fy / z + cy).astype(int)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
        u, v, z = u[ok], v[ok], z[ok]
        if len(u) < 100:
            continue
        # splat 2x2 blocks for denser coverage
        for du in (0, 1):
            for dv in (0, 1):
                uu = np.clip(u + du, 0, W - 1)
                vv = np.clip(v + dv, 0, H - 1)
                write = (depth[vv, uu] == 0) | (z * 1000 < depth[vv, uu])
                depth[vv[write], uu[write]] = z[write] * 1000
                mask[vv[write], uu[write]] = inst

        ys, xs = np.where(mask == inst)
        if len(ys) == 0:
            continue
        gts["class_ids"].append(cls_id)
        gts["instance_ids"].append(inst)
        gts["model_list"].append(name)
        gts["scales"].append(scale)
        gts["rotations"].append(R)
        gts["translations"].append(t)
        gts["bboxes"].append(np.array([ys.min(), xs.min(), ys.max(), xs.max()]))
        gts["handle_visibility"].append(1)
        # NOCS test labels also carry the scaled 4x4 pose and bbox size
        srt = np.eye(4)
        srt[:3, :3] = scale * R
        srt[:3, 3] = t
        gts["poses"].append(srt)
        extent = model.max(axis=0) - model.min(axis=0)
        gts["size"].append(extent * scale)

    for k in ("poses", "size", "bboxes", "rotations", "translations",
              "scales", "handle_visibility", "class_ids", "instance_ids"):
        gts[k] = np.asarray(gts[k])
    return rgb, depth.astype(np.uint16), mask, gts


def make_synthetic_nocs_dir(root: str, n_camera_scenes: int = 4, n_real_scenes: int = 2,
                            n_models: int = 3, seed: int = 0) -> str:
    """Write a miniature NOCS-format tree under ``root`` and return it."""
    rng = np.random.default_rng(seed)
    model_names = [f"model_{i}" for i in range(n_models)]
    models = {n: _box_model(rng) for n in model_names}

    os.makedirs(os.path.join(root, "obj_models"), exist_ok=True)
    for pkl in ("camera_train.pkl", "real_train.pkl", "camera_val.pkl", "real_test.pkl"):
        with open(os.path.join(root, "obj_models", pkl), "wb") as f:
            pickle.dump(models, f)

    mug_sym = {}

    def write_split(split_dir, list_file, n_scenes, intrinsics, scene_prefix):
        entries = []
        for s in range(n_scenes):
            scene = f"{scene_prefix}_{s}"
            scene_dir = os.path.join(root, split_dir, scene)
            os.makedirs(scene_dir, exist_ok=True)
            img_id = 0
            rgb, depth, mask, gts = render_scene(rng, models, model_names, intrinsics)
            base = os.path.join(scene_dir, f"{img_id:04d}")
            png.imwrite(base + "_color.png", rgb)
            png.imwrite(base + "_depth.png", depth)
            mask_bgr = np.zeros((*mask.shape, 3), np.uint8)
            mask_bgr[:, :, 2] = mask
            png.imwrite(base + "_mask.png", mask_bgr)
            with open(base + "_label.pkl", "wb") as f:
                pickle.dump(gts, f)
            entries.append(f"{os.path.basename(split_dir)}/{scene}/{img_id:04d}")
            mug_sym[f"{scene}_res"] = {img_id: 1}
        with open(os.path.join(root, list_file), "w") as f:
            f.write("\n".join(entries) + "\n")

    os.makedirs(os.path.join(root, "CAMERA"), exist_ok=True)
    os.makedirs(os.path.join(root, "Real", "train"), exist_ok=True)
    write_split("CAMERA/train", "CAMERA/train_list.txt", n_camera_scenes,
                CAMERA_INTRINSICS, "scene")
    write_split("CAMERA/val", "CAMERA/val_list.txt", max(1, n_camera_scenes // 2),
                CAMERA_INTRINSICS, "scene")
    write_split("Real/train", "Real/train_list.txt", n_real_scenes, REAL_INTRINSICS, "scene")
    write_split("Real/test", "Real/test_list.txt", max(1, n_real_scenes), REAL_INTRINSICS,
                "scene")

    with open(os.path.join(root, "Real", "train", "mug_handle.pkl"), "wb") as f:
        pickle.dump(mug_sym, f)
    return root


def make_synthetic_mrcnn_results(nocs_dir: str, result_dir: str, test_source: str = "real_test",
                                 tracking: bool = False) -> str:
    """Fabricate Mask R-CNN detection pkls from the synthetic GT labels, in
    the flat format of ``evaluation_single`` or the tracking layout
    ('pred'/'gt' sub-dicts) of ``evaluation_tracking``."""
    file_path = "CAMERA/val_list.txt" if test_source == "val" else "Real/test_list.txt"
    with open(os.path.join(nocs_dir, file_path)) as f:
        img_list = [os.path.join(file_path.split("/")[0], line.rstrip("\n")) for line in f]
    out_dir = os.path.join(result_dir, "mrcnn_results", test_source)
    os.makedirs(out_dir, exist_ok=True)

    for path in img_list:
        img_path = os.path.join(nocs_dir, path)
        with open(img_path + "_label.pkl", "rb") as f:
            gts = pickle.load(f)
        mask = png.imread(img_path + "_mask.png")[:, :, 2]
        n = len(gts["class_ids"])
        masks = np.stack([mask == gts["instance_ids"][i] for i in range(n)], axis=-1)
        pred = {
            "class_ids": np.asarray(gts["class_ids"]),
            "rois": np.asarray(gts["bboxes"]),
            "masks": masks,
            "scores": np.ones(n, dtype=np.float32),
        }
        if tracking:
            entry = {
                "pred": {**pred, "seen": np.zeros(n, dtype=bool)},
                "gt": {
                    "poses": np.asarray(gts["poses"], dtype=np.float32),
                    "handle_visibility": np.asarray(gts["handle_visibility"]),
                    "model_list": np.asarray(gts["model_list"]),
                },
            }
        else:
            entry = pred
        parts = img_path.split("/")
        out_name = "results_{}_{}_{}.pkl".format(test_source.split("_")[-1], parts[-2], parts[-1])
        with open(os.path.join(out_dir, out_name), "wb") as f:
            pickle.dump(entry, f)
    return out_dir


def synthetic_batch(rng: np.random.Generator, bs: int = 8, n_pts: int = 1024,
                    n_model: int = 1024) -> Dict[str, np.ndarray]:
    """Raw (pre-``process_batch``) batch with consistent pose geometry."""
    batch = {
        "pcl_in": [], "cat_id": [], "rotation": [], "translation": [],
        "fsnet_scale": [], "sym_info": [], "mean_shape": [], "aug_bb": [],
        "aug_rt_t": [], "aug_rt_R": [], "model_point": [], "nocs_scale": [],
        "handle_visibility": [],
    }
    for _ in range(bs):
        model = _box_model(rng, n_model)
        cls_id = int(rng.integers(1, len(CAT_NAMES) + 1))
        cat_name = CAT_NAMES[cls_id - 1]
        scale = float(rng.uniform(0.15, 0.3))
        R = _random_rotation(rng)
        t = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                      rng.uniform(0.8, 1.4)], np.float32)
        obs = scale * model @ R.T + t
        ids = rng.permutation(n_model)[:n_pts]
        fsnet_scale, mean_shape = get_fs_net_scale(cat_name, model, scale)
        batch["pcl_in"].append(obs[ids])
        batch["cat_id"].append(cls_id - 1)
        batch["rotation"].append(R)
        batch["translation"].append(t)
        batch["fsnet_scale"].append(fsnet_scale / 1000.0)
        batch["sym_info"].append(get_sym_info(cat_name).astype(np.float32))
        batch["mean_shape"].append(mean_shape / 1000.0)
        batch["aug_bb"].append(rng.uniform(0.8, 1.2, 3).astype(np.float32))
        batch["aug_rt_t"].append((rng.uniform(-50, 50, 3) / 1000.0).astype(np.float32))
        batch["aug_rt_R"].append(_random_rotation(rng))
        batch["model_point"].append(model)
        batch["nocs_scale"].append(scale)
        batch["handle_visibility"].append(1)
    return {k: np.stack([np.asarray(v) for v in vs]).astype(
        np.float32 if k not in ("cat_id", "handle_visibility") else np.int32)
        for k, vs in batch.items()}
