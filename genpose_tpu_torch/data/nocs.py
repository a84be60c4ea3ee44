"""NOCS CAMERA/Real training and test samples (counterpart of ``genpose_tpu/data/nocs.py``).

``NOCSDataset`` reads the image quads of a NOCS-format tree
(``*_color.png``, ``*_depth.png``, ``*_mask.png``, ``*_label.pkl``), picks
one foreground instance per sample, jitters its box (DZI), crops the pixel
coordinates, mask and depth to ``img_size``, deforms the mask
(``defor_2D``), back-projects and samples ``n_pts`` points, and returns
the per-category FS-Net scale residual, symmetry descriptor and the draws
of the batched 3-D augmentation (ref ``datasets_genpose.py:55-505``).

The same ``(seed, index, visit)`` gives the JAX dataset's sample bit for
bit: PNGs are decoded by ``utils/png.py`` (no cv2), crops are
``dataset_utils.crop_resize_by_warp_affine`` (cv2's NEAREST pixels), and
back-projection and sampling run the JAX package's stream in the port's
host C helper (``dataset_utils.backproject_and_sample``, ``native/``).  A
corrupt sample (a missing or unreadable file, too few valid pixels, fewer
than 50 points) is skipped for the next index.  The colour image is decoded only for its
size and as the check that it is readable, as in JAX.

A sample is a dict of numpy arrays and a path string: no tensors, so
that forked loader workers touch nothing of CUDA.
"""

from __future__ import annotations

import os
import pickle
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np

from genpose_tpu_torch.config import Deform2DConfig, DynamicZoomInConfig
from genpose_tpu_torch.data.dataset_utils import (
    aug_bbox_DZI,
    backproject_and_sample,
    crop_resize_by_warp_affine,
    defor_2D,
    get_2d_coord_np,
    get_bbox,
    load_depth,
)
from genpose_tpu_torch.utils import png

CAT_NAMES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]
CAT_NAME2ID = {n: i + 1 for i, n in enumerate(CAT_NAMES)}
ID2CAT_NAME = {str(i + 1): n for i, n in enumerate(CAT_NAMES)}
ID2CAT_NAME_CAMERA = {
    "1": "02876657", "2": "02880940", "3": "02942699",
    "4": "02946921", "5": "03642806", "6": "03797390",
}

CAMERA_INTRINSICS = np.array(
    [[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]], dtype=np.float32)
REAL_INTRINSICS = np.array(
    [[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], dtype=np.float32)

# FS-Net per-category mean sizes in mm (ref datasets_genpose.py:414-480)
_FS_NET_UNITS = {
    "bottle": (87, 220, 89),
    "bowl": (165, 80, 165),
    "camera": (88, 128, 156),
    "can": (68, 146, 72),
    "laptop": (346, 200, 335),
    "mug": (146, 83, 114),
    "02876657": (324 / 4, 874 / 4, 321 / 4),
    "02880940": (675 / 4, 271 / 4, 675 / 4),
    "02942699": (464 / 4, 487 / 4, 702 / 4),
    "02946921": (450 / 4, 753 / 4, 460 / 4),
    "03642806": (581 / 4, 445 / 4, 672 / 4),
    "03797390": (670 / 4, 540 / 4, 497 / 4),
}

# a file the dataset cannot read: the sample is skipped, as cv2.imread's None is
_UNREADABLE = (OSError, ValueError, zlib.error)


def get_fs_net_scale(cat_name: str, model: np.ndarray, nocs_scale: float):
    """FS-Net scale residual + mean shape in mm (ref ``datasets_genpose.py:414-480``)."""
    lx = model[:, 0].max() - model[:, 0].min()
    ly = model[:, 1].max() - model[:, 1].min()
    lz = model[:, 2].max() - model[:, 2].min()
    lx_t, ly_t, lz_t = lx * nocs_scale * 1000, ly * nocs_scale * 1000, lz * nocs_scale * 1000
    if cat_name not in _FS_NET_UNITS:
        raise NotImplementedError(f"category {cat_name} not recorded")
    ux, uy, uz = _FS_NET_UNITS[cat_name]
    return (
        np.array([lx_t - ux, ly_t - uy, lz_t - uz]),
        np.array([ux, uy, uz]),
    )


def get_sym_info(cat_name: str, mug_handle: int = 1) -> np.ndarray:
    """Symmetry descriptor (ref ``datasets_genpose.py:483-505``)."""
    if cat_name in ("bottle", "bowl"):
        return np.array([1, 1, 0, 1], dtype=np.int8)
    if cat_name == "camera":
        return np.array([0, 0, 0, 0], dtype=np.int8)
    if cat_name == "can":
        return np.array([1, 1, 1, 1], dtype=np.int8)
    if cat_name == "laptop":
        return np.array([0, 1, 0, 0], dtype=np.int8)
    if cat_name == "mug" and mug_handle == 1:
        return np.array([0, 1, 0, 0], dtype=np.int8)
    if cat_name == "mug" and mug_handle == 0:
        return np.array([1, 0, 0, 0], dtype=np.int8)
    return np.array([0, 0, 0, 0], dtype=np.int8)


def get_rotation_np(x_, y_, z_) -> np.ndarray:
    """Rz @ Ry @ Rx from degrees (ref ``data_augmentation.py:197-213``)."""
    x, y, z = (np.float64(v) / 180.0 * np.pi for v in (x_, y_, z_))
    R_x = np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)], [0, np.sin(x), np.cos(x)]])
    R_y = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]])
    R_z = np.array([[np.cos(z), -np.sin(z), 0], [np.sin(z), np.cos(z), 0], [0, 0, 1]])
    return (R_z @ R_y @ R_x).astype(np.float32)


def _image_lists(source: str, mode: str):
    """(image list files, object model files) of a source and mode
    (ref ``datasets_genpose.py:68-92``): CAMERA+Real tests on Real only."""
    img_list_path = ["CAMERA/train_list.txt", "Real/train_list.txt",
                     "CAMERA/val_list.txt", "Real/test_list.txt"]
    model_file_path = ["obj_models/camera_train.pkl", "obj_models/real_train.pkl",
                       "obj_models/camera_val.pkl", "obj_models/real_test.pkl"]
    if mode == "train":
        img_list_path, model_file_path = img_list_path[:2], model_file_path[:2]
    else:
        img_list_path, model_file_path = img_list_path[2:], model_file_path[2:]
    if source == "CAMERA":
        return img_list_path[:1], model_file_path[:1]
    if source == "Real" or mode == "test":
        return img_list_path[-1:], model_file_path[-1:]
    return img_list_path, model_file_path


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def refuse_rgb_encoder(pts_encoder: str) -> None:
    """Raise for an encoder whose input needs the object's RGB crop, which
    this loader does not cut (GenPose++'s ``dinov2_pointnet2``)."""
    if pts_encoder == "dinov2_pointnet2":
        raise NotImplementedError(
            "the NOCS loader cuts no RGB crops and gives the points no crop pixels, which "
            "pts_encoder='dinov2_pointnet2' needs; feed process_batch raw batches that hold "
            "'rgb' (uint8 [bs, 224, 224, 3]) and 'pix' ([bs, N, 2])")


class NOCSDataset:
    """Map-style dataset over NOCS image quads (ref ``NOCSDataSet``).

    ``fetch(index, visit)`` draws from ``np.random.default_rng((seed, index,
    visit))``: each visit of an index gets fresh augmentation draws, the same
    in every process.  ``__getitem__`` numbers the visits itself, under a
    lock; the loader numbers them in its parent process and calls ``fetch``.
    """

    def __init__(self, data_dir: str, source: str = "CAMERA+Real", mode: str = "train",
                 n_pts: int = 1024, img_size: int = 256, per_obj: str = "",
                 dzi_params: Optional[DynamicZoomInConfig] = None,
                 deform_2d_params: Optional[Deform2DConfig] = None, seed: int = 0):
        if source not in ("CAMERA", "Real", "CAMERA+Real"):
            raise ValueError(f"unknown source {source!r}")
        if mode not in ("train", "test"):
            raise ValueError(f"unknown mode {mode!r}")
        self.data_dir = data_dir
        self.source = source
        self.mode = mode
        self.n_pts = n_pts
        self.img_size = img_size
        self.per_obj = per_obj
        self.dzi_params = dzi_params or DynamicZoomInConfig()
        self.deform_2d_params = deform_2d_params or Deform2DConfig()
        self.seed = seed
        self._visits: Dict[int, int] = {}
        self._visit_lock = threading.Lock()

        img_list_path, model_file_path = _image_lists(source, mode)
        img_list: List[str] = []
        subset_len = []
        for path in img_list_path:
            with open(os.path.join(data_dir, path)) as f:
                img_list += [os.path.join(path.split("/")[0], line.rstrip("\n")) for line in f]
            subset_len.append(len(img_list))
        if len(subset_len) == 2:
            self.subset_len = [subset_len[0], subset_len[1] - subset_len[0]]
        else:
            self.subset_len = subset_len

        self.id2cat_name = ID2CAT_NAME_CAMERA if source == "CAMERA" else ID2CAT_NAME
        self.per_obj_id = CAT_NAME2ID.get(per_obj) if per_obj in CAT_NAMES else None
        if self.per_obj_id is not None:
            filtered = []
            camera_len = real_len = 0
            for p in img_list:
                try:
                    gts = _load_pickle(os.path.join(data_dir, p + "_label.pkl"))
                except (OSError, pickle.UnpicklingError, EOFError):
                    continue
                if self.per_obj_id in gts["class_ids"]:
                    filtered.append(p)
                    if "CAMERA" in p.split("/"):
                        camera_len += 1
                    else:
                        real_len += 1
            img_list = filtered
            if len(subset_len) == 2:
                self.subset_len = [camera_len, real_len]

        self.img_list = img_list
        self.length = len(img_list)

        self.models: Dict[str, np.ndarray] = {}
        for path in model_file_path:
            self.models.update(_load_pickle(os.path.join(data_dir, path)))

        mug_meta_path = os.path.join(data_dir, "obj_models/mug_meta.pkl")
        self.mug_meta = _load_pickle(mug_meta_path) if os.path.exists(mug_meta_path) else None
        mug_handle_path = os.path.join(data_dir, "Real/train/mug_handle.pkl")
        self.mug_sym = _load_pickle(mug_handle_path) if os.path.exists(mug_handle_path) else {}

    def __len__(self):
        return self.length

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_visit_lock"] = None  # a lock does not pickle; each process has its own
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._visit_lock = threading.Lock()

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        with self._visit_lock:
            visit = self._visits[index] = self._visits.get(index, 0) + 1
        return self.fetch(index, visit)

    def fetch(self, index: int, visit: int) -> Dict[str, np.ndarray]:
        """The sample of ``index`` at its ``visit``-th draw; a corrupt sample
        gives the next index's, drawn from the same generator."""
        rng = np.random.default_rng((self.seed, index, visit))
        for _ in range(len(self)):
            item = self._load_one(index, rng)
            if item is not None:
                return item
            index = (index + 1) % len(self)
        raise RuntimeError("all dataset items failed to load")

    def _mug_handle(self, gts, idx: int, img_path: str, img_type: str) -> int:
        """Handle visibility (ref ``datasets_genpose.py:239-248``): a Real
        train mug looks it up in ``mug_handle.pkl`` (a dict per scene, where a
        missing frame counts as visible, or a sequence indexed by frame), a
        Real test mug reads its label, anything else is 1."""
        if gts["class_ids"][idx] != 6 or img_type != "real":
            return 1
        if self.mode != "train":
            return gts["handle_visibility"][idx]
        parts = img_path.split("/")
        scene_label, img_id = parts[-2] + "_res", int(parts[-1])
        scene = self.mug_sym.get(scene_label, {})
        if isinstance(scene, dict):
            return scene.get(img_id, 1)
        return self.mug_sym[scene_label][img_id]

    def _load_one(self, index: int, rng: np.random.Generator) -> Optional[Dict[str, np.ndarray]]:
        img_path = os.path.join(self.data_dir, self.img_list[index])
        try:
            gts = _load_pickle(img_path + "_label.pkl")
        except (OSError, pickle.UnpicklingError, EOFError):
            return None
        if "CAMERA" in img_path.split("/"):
            out_camK, img_type = CAMERA_INTRINSICS, "syn"
        else:
            out_camK, img_type = REAL_INTRINSICS, "real"

        if self.per_obj_id is not None:
            matches = np.where(np.asarray(gts["class_ids"]) == self.per_obj_id)[0]
            if matches.size == 0:
                return None
            idx = int(matches[0])
        else:
            idx = int(rng.integers(0, len(gts["instance_ids"])))
        mug_handle = self._mug_handle(gts, idx, img_path, img_type)

        try:
            rgb = png.imread(img_path + "_color.png")
            depth = load_depth(img_path + "_depth.png")
            mask = png.imread(img_path + "_mask.png")[:, :, 2]
        except _UNREADABLE:
            return None
        im_H, im_W = rgb.shape[0], rgb.shape[1]
        coord_2d = get_2d_coord_np(im_W, im_H).transpose(1, 2, 0)

        inst_id = gts["instance_ids"][idx]
        rmin, rmax, cmin, cmax = get_bbox(gts["bboxes"][idx], im_H, im_W)
        bbox_xyxy = np.array([cmin, rmin, cmax, rmax])
        bbox_center, scale = aug_bbox_DZI(self.dzi_params, bbox_xyxy, im_H, im_W, rng)
        roi_coord_2d = crop_resize_by_warp_affine(
            coord_2d, bbox_center, scale, self.img_size).transpose(2, 0, 1)
        mask_target = (mask == inst_id).astype(np.float32)
        roi_mask = crop_resize_by_warp_affine(
            mask_target, bbox_center, scale, self.img_size)[None]
        roi_depth = crop_resize_by_warp_affine(
            depth.astype(np.float32), bbox_center, scale, self.img_size)[None]

        if (roi_depth > 0).sum() <= 1.0:
            return None
        if (roi_mask.astype(bool) * (roi_depth > 0)).sum() <= 1.0:
            return None

        cat_id = gts["class_ids"][idx] - 1  # 0-indexed
        model = self.models[gts["model_list"][idx]].astype(np.float32)
        nocs_scale = gts["scales"][idx]
        cat_name = self.id2cat_name[str(cat_id + 1)]
        fsnet_scale, mean_shape = get_fs_net_scale(cat_name, model, nocs_scale)
        fsnet_scale, mean_shape = fsnet_scale / 1000.0, mean_shape / 1000.0

        roi_mask_def = defor_2D(roi_mask, rng, rand_r=self.deform_2d_params.roi_mask_r,
                                rand_pro=self.deform_2d_params.roi_mask_pro)
        n_valid, pcl_in = backproject_and_sample(
            roi_depth, out_camK, roi_coord_2d, roi_mask_def, self.n_pts, rng,
            scale=1.0 / 1000.0)
        if n_valid < 50:
            return None

        sym_info = get_sym_info(cat_name, mug_handle)
        bb_aug, rt_aug_t, rt_aug_R = self.generate_aug_parameters(rng)
        return {
            "pcl_in": pcl_in.astype(np.float32),
            "cat_id": np.int32(cat_id),
            "rotation": gts["rotations"][idx].astype(np.float32),
            "translation": gts["translations"][idx].astype(np.float32),
            "fsnet_scale": fsnet_scale.astype(np.float32),
            "sym_info": sym_info.astype(np.float32),
            "mean_shape": mean_shape.astype(np.float32),
            "aug_bb": bb_aug,
            "aug_rt_t": rt_aug_t,
            "aug_rt_R": rt_aug_R,
            "model_point": model,
            "nocs_scale": np.float32(nocs_scale),
            "handle_visibility": np.int32(mug_handle),
            "path": img_path,
        }

    def generate_aug_parameters(self, rng: np.random.Generator, s_x=(0.8, 1.2),
                                s_y=(0.8, 1.2), s_z=(0.8, 1.2), ax=50, ay=50, az=50, a=15):
        """Per-sample augmentation draws (ref ``datasets_genpose.py:400-411``):
        (box scale [3], translation [3] in m, rotation [3, 3])."""
        ex, ey, ez = rng.random(3)
        ex = ex * (s_x[1] - s_x[0]) + s_x[0]
        ey = ey * (s_y[1] - s_y[0]) + s_y[0]
        ez = ez * (s_z[1] - s_z[0]) + s_z[0]
        Rm = get_rotation_np(rng.uniform(-a, a), rng.uniform(-a, a), rng.uniform(-a, a))
        dx = rng.random() * 2 * ax - ax
        dy = rng.random() * 2 * ay - ay
        dz = rng.random() * 2 * az - az
        return (np.array([ex, ey, ez], dtype=np.float32),
                np.array([dx, dy, dz], dtype=np.float32) / 1000.0, Rm)
