"""Synthetic raw batches (counterpart of ``genpose_tpu/data/synthetic.py:240-275``).

``synthetic_batch`` makes a raw, pre-``process_batch`` batch of object clouds
with consistent pose geometry: points on the faces of random boxes
(NOCS-normalised models), scaled, rotated and placed 0.8-1.4 m in front of
the camera, with the per-category FS-Net scale residuals and symmetry
descriptors of the NOCS loader (``genpose_tpu/data/nocs.py:79-110``).
Numpy only, copied from the JAX package: the same ``np.random.Generator``
state gives the same arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

CAT_NAMES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]

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
