"""Point-cloud pose pictures: grid images and per-step diffusion frames
(counterpart of ``genpose_tpu/utils/visualize.py``).

The same artifacts as the JAX package (front and top splat views per
sample, grids of up to 16 rows for the metrics logger, the result grid and
the diffusion steps at eval time), drawn on the host with numpy and the
port's pose ops (``ops/pose.py::transform_batch_pts``), without OpenCV,
which the card's machine lacks:

- ``resize_img_keep_ratio`` reproduces ``cv2.resize``'s INTER_LINEAR on
  uint8 images (11-bit fixed-point coefficients, cv2's rounding) and
  ``cv2.copyMakeBorder`` as ``np.pad``;
- images are written with ``utils/png.py``;
- ``save_video`` departs from the JAX package: the JAX function encodes one
  mp4 a sample through ``cv2.VideoWriter``, and no video encoder is at
  hand here, so each sample's frames are written as numbered PNGs in
  ``example_{i}/`` (``frame_{k:04d}.png``), the images the JAX video is
  encoded from, losslessly.

matplotlib is imported only inside the SO(3) drawing
(``utils/so3_visualize.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from genpose_tpu_torch.ops.pose import transform_batch_pts
from genpose_tpu_torch.utils import png

# Default render cameras (reference ``visualize.py:167-187``): a 640-res
# pinhole intrinsic rendered at 360x360, viewed from 0.5 m in front / above.
_INTRINSICS = {"fx": 502.30, "fy": 502.30, "cx": 319.5, "cy": 319.5,
               "xres": 640, "yres": 640}
_TOP_VIEW = {"look_at": np.zeros(3), "location": np.array([0.0, 0.5, 0.0]),
             "up": np.array([0.0, 0.0, -1.0])}
_FRONT_VIEW = {"look_at": np.zeros(3), "location": np.array([0.0, 0.0, -0.5]),
               "up": np.array([0.0, -1.0, 0.0])}

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = np.float32(1 << _COEF_BITS)


def get_camera_pose(location, look_at, up):
    """Look-at camera -> camera-to-world (R, T) (ref ``visualize.py:60-94``)."""
    location = np.asarray(location, np.float64)
    z = np.asarray(look_at, np.float64) - location
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64) / np.linalg.norm(up)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    R = np.stack([x, y, z], axis=1)
    return R, location


def project_pts_to_image(pts: np.ndarray, image_size=(360, 360),
                         camera_intrinsics: Dict = _INTRINSICS,
                         camera_extrinsics: Dict = _FRONT_VIEW) -> np.ndarray:
    """Splat an (N, 3|6) cloud to an RGB uint8 image (ref
    ``visualize.py:95-164``: white background, the last write wins a pixel,
    uv clamped to the frame; the colour channels, when there are six, as
    RGB)."""
    xres, yres = image_size
    sx = xres / camera_intrinsics["xres"]
    sy = yres / camera_intrinsics["yres"]
    fx, fy = camera_intrinsics["fx"] * sx, camera_intrinsics["fy"] * sy
    cx, cy = camera_intrinsics["cx"] * sx, camera_intrinsics["cy"] * sy

    R, T = get_camera_pose(camera_extrinsics["location"], camera_extrinsics["look_at"],
                           camera_extrinsics["up"])
    xyz = np.asarray(pts[:, :3], np.float64)
    cam = (xyz - T) @ R  # world -> camera (R is orthonormal)
    z = cam[:, 2]
    z = np.where(np.abs(z) < 1e-9, 1e-9, z)
    u = np.clip(np.rint(fx * cam[:, 0] / z + cx).astype(int), 0, xres - 1)
    v = np.clip(np.rint(fy * cam[:, 1] / z + cy).astype(int), 0, yres - 1)

    image = np.full((yres, xres, 3), 255, dtype=np.uint8)
    if pts.shape[1] >= 6:
        image[v, u] = np.clip(pts[:, 3:6], 0, 255).astype(np.uint8)
    else:
        image[v, u] = np.array([0, 0, 255], np.uint8)
    return image


def pts_views(pts: np.ndarray):
    """(front, top) splat views of one cloud (ref ``visualize.py:167-197``)."""
    front = project_pts_to_image(pts, camera_extrinsics=_FRONT_VIEW)
    top = project_pts_to_image(pts, camera_extrinsics=_TOP_VIEW)
    return front, top


def _linear_taps(dst: int, src: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: first source index [dst] and
    the two fixed-point weights [dst] (float32 position, rounded to the
    nearest, ties to even, as ``saturate_cast<short>``).  ``clamp`` is the
    horizontal pass's edge rule (weight 0 past either edge); the vertical
    pass clamps the row indices only."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0
        s = np.clip(s, 0, src - 1)
    a0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int64)
    a1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    return s, a0, a1


def resize_linear_u8(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a uint8 image [H, W]
    or [H, W, C], reproduced in numpy: a horizontal pass into integers with
    11-bit weights, then the vertical pass's fixed-point sum
    ((b0 (S0 >> 4)) >> 16) + ((b1 (S1 >> 4)) >> 16) + 2) >> 2."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8 images, not {img.dtype}")
    h, w = int(size[0]), int(size[1])
    src_h, src_w = img.shape[:2]
    sx, a0, a1 = _linear_taps(w, src_w, clamp=True)
    rows = img.astype(np.int64)
    rows = (rows[:, sx] * _expand(a0, img.ndim)
            + rows[:, np.minimum(sx + 1, src_w - 1)] * _expand(a1, img.ndim))
    sy, b0, b1 = _linear_taps(h, src_h, clamp=False)
    r0 = rows[np.clip(sy, 0, src_h - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, src_h - 1)] >> 4
    b0, b1 = _expand(b0, img.ndim, axis=0), _expand(b1, img.ndim, axis=0)
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _expand(weights: np.ndarray, ndim: int, axis: int = 1) -> np.ndarray:
    """Weights along ``axis`` of an image of ``ndim`` dimensions."""
    shape = [1] * ndim
    shape[axis] = -1
    return weights.reshape(shape)


def resize_img_keep_ratio(img: np.ndarray, target_size) -> np.ndarray:
    """Aspect-preserving resize with black padding (ref ``visualize.py:18-29``;
    ``cv2.resize`` + ``cv2.copyMakeBorder`` as ``resize_linear_u8`` + ``np.pad``)."""
    old = img.shape[:2]
    ratio = min(target_size[i] / old[i] for i in range(2))
    new = tuple(int(s * ratio) for s in old)
    img = resize_linear_u8(img, new)
    pad_h, pad_w = target_size[0] - new[0], target_size[1] - new[1]
    pads = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
    return np.pad(img, pads + [(0, 0)] * (img.ndim - 2))


def create_grid_image(batch_pts, batch_pred_pose, batch_gt_pose=None, batch_color=None,
                      pose_mode: str = "rot_matrix", inverse_pose: bool = False):
    """Row-per-sample comparison strip (ref ``visualize.py:200-261``).

    Columns: [color?] pred-front pred-top [gt-front gt-top]; up to 16 rows.
    Returns ``(grid, images)`` as uint8 numpy, grid shaped (H*rows, W, 3).
    """
    batch_pts = np.asarray(batch_pts)
    n = min(batch_pts.shape[0], 16)
    batch_pts = batch_pts[:n]

    def moved(poses):
        return transform_batch_pts(torch.as_tensor(np.asarray(batch_pts, np.float32)),
                                   torch.as_tensor(np.asarray(poses, np.float32)[:n]),
                                   pose_mode, inverse_pose).numpy()

    pred_pts = moved(batch_pred_pose)
    gt_pts = None if batch_gt_pose is None else moved(batch_gt_pose)

    rows: List[np.ndarray] = []
    for i in range(n):
        cols = []
        pf, pt = pts_views(pred_pts[i])
        if batch_color is not None:
            color = np.asarray(batch_color[i])
            if color.ndim == 3 and color.shape[0] in (3, 4):
                color = color.transpose(1, 2, 0)[..., :3]
            cols.append(resize_img_keep_ratio(color.astype(np.uint8),
                                              [pf.shape[0], pf.shape[1]]))
        cols += [pf, pt]
        if gt_pts is not None:
            gf, gt_img = pts_views(gt_pts[i])
            cols += [gf, gt_img]
        rows.append(np.concatenate(cols, axis=1))
    images = np.stack(rows)          # (n, H, W*, 3)
    grid = np.concatenate(rows, axis=0)
    return grid, images


def save_video(save_path: str, batch_pts, batch_pred_pose_list: Sequence, batch_gt_pose=None,
               batch_color=None, pose_mode: str = "rot_matrix",
               inverse_pose: bool = False) -> int:
    """Each sample's pose trajectory as numbered PNG frames,
    ``example_{i}/frame_{k:04d}.png`` (ref ``visualize.py:264-293``).

    Departure from the JAX package, which encodes ``example_{i}.mp4``
    through ``cv2.VideoWriter`` at a frame rate it takes: no video encoder
    is at hand, so the frames the video would be encoded from are written
    as they are, and a frame sequence has no rate.  Returns the number of
    frames written."""
    written = 0
    for k, batch_pose in enumerate(batch_pred_pose_list):
        _, images = create_grid_image(batch_pts, batch_pose, batch_gt_pose, batch_color,
                                      pose_mode, inverse_pose)
        for i in range(images.shape[0]):
            out = os.path.join(save_path, f"example_{i}")
            os.makedirs(out, exist_ok=True)
            png.imwrite(os.path.join(out, f"frame_{k:04d}.png"), images[i][..., ::-1])
            written += 1
    return written


def test_time_visualize(save_path, data, res, in_process_sample, pose_mode: str,
                        o2c_pose: bool) -> int:
    """The result grid ``res_grid.png`` and each sample's diffusion frames
    (``save_video``) (ref ``visualize.py:296-330``).

    in_process_sample: (bs, steps, pose_dim) sampler trajectory; its last
    half, at most ~100 steps of it, is drawn.  Returns the frames written.
    """
    os.makedirs(save_path, exist_ok=True)
    pts = np.asarray(data["pts"])
    if "pts_color" in data:
        pts = np.concatenate([pts, np.asarray(data["pts_color"])], axis=2)
    n = min(pts.shape[0], 16)
    gt = data.get("gt_pose")
    gt = None if gt is None else np.asarray(gt)[:n]

    grid, _ = create_grid_image(pts[:n], np.asarray(res)[:n], gt, None, pose_mode, o2c_pose)
    png.imwrite(os.path.join(save_path, "res_grid.png"), grid[..., ::-1])

    traj = np.asarray(in_process_sample).transpose(1, 0, 2)  # (steps, bs, D)
    traj = traj[-traj.shape[0] // 2:]           # the last 50% of the trajectory
    if traj.shape[0] > 100:
        traj = traj[:: traj.shape[0] // 100]
    return save_video(save_path, pts[:n], traj[:, :n], gt, None, pose_mode=pose_mode,
                      inverse_pose=o2c_pose)


def standardize_bbox(pcl: np.ndarray, points_per_object: int,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Subsample + normalize a cloud into [-0.5, 0.5]^3 (ref ``visualize.py:391-404``)."""
    rng = rng or np.random.default_rng(0)
    if pcl.shape[0] > points_per_object:
        pcl = pcl[rng.choice(pcl.shape[0], points_per_object, replace=False)]
    mins, maxs = pcl.min(axis=0), pcl.max(axis=0)
    center = (mins + maxs) / 2.0
    scale = (maxs - mins).max()
    return ((pcl - center) / scale).astype(np.float32)


def generate_xml_for_mitsuba(pts: np.ndarray, save_path: Optional[str] = None,
                             image_size=(640, 360), fov: float = 20.0,
                             camera=("3,3,3", "0,0,0", "0,0,1"),
                             light=("-4,4,20", "0,0,0", "0,0,1"),
                             sphere_radius: float = 0.025,
                             points_per_object: int = 2048) -> str:
    """Mitsuba scene XML rendering a point cloud as shaded spheres (ref
    ``visualize.py:383-520``): path-traced perspective camera, one sphere
    per point coloured by its normalised position, ground plane and area
    light.  Returns the XML; writes it when ``save_path`` is given."""
    pcl = standardize_bbox(np.asarray(pts)[:, :3], points_per_object)
    head = f"""<scene version="0.6.0">
    <integrator type="path"><integer name="maxDepth" value="-1"/></integrator>
    <sensor type="perspective">
        <float name="farClip" value="100"/>
        <float name="nearClip" value="0.1"/>
        <transform name="toWorld">
            <lookat origin="{camera[0]}" target="{camera[1]}" up="{camera[2]}"/>
        </transform>
        <float name="fov" value="{fov}"/>
        <sampler type="ldsampler"><integer name="sampleCount" value="256"/></sampler>
        <film type="hdrfilm">
            <integer name="width" value="{image_size[0]}"/>
            <integer name="height" value="{image_size[1]}"/>
            <rfilter type="gaussian"/>
            <boolean name="banner" value="false"/>
        </film>
    </sensor>
    <bsdf type="roughplastic" id="surfaceMaterial">
        <string name="distribution" value="ggx"/>
        <float name="alpha" value="0.05"/>
        <float name="intIOR" value="1.46"/>
        <rgb name="diffuseReflectance" value="1,1,1"/>
    </bsdf>
"""
    balls = []
    for x, y, z in pcl:
        c = np.clip([x + 0.5, y + 0.5, z + 0.5 - 0.0125], 0.001, 1.0)
        c = c / np.linalg.norm(c)
        balls.append(
            f'    <shape type="sphere"><float name="radius" value="{sphere_radius}"/>'
            f'<transform name="toWorld"><translate x="{x}" y="{y}" z="{z}"/></transform>'
            f'<bsdf type="diffuse"><rgb name="reflectance" value="{c[0]},{c[1]},{c[2]}"/>'
            f'</bsdf></shape>\n')
    tail = f"""    <shape type="rectangle">
        <ref name="bsdf" id="surfaceMaterial"/>
        <transform name="toWorld"><scale x="100" y="100" z="1"/><translate x="0" y="0" z="-0.2"/></transform>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <scale x="10" y="10" z="1"/>
            <lookat origin="{light[0]}" target="{light[1]}" up="{light[2]}"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="6,6,6"/></emitter>
    </shape>
</scene>
"""
    xml = head + "".join(balls) + tail
    if save_path:
        with open(save_path, "w") as f:
            f.write(xml)
    return xml


def so3_visualization(pred_rot, energy=None, gt_rot=None, save_path="./so3_distribution.png"):
    """Energy-weighted SO(3) scatter (ref ``visualize.py:355-380``)."""
    from genpose_tpu_torch.utils.so3_visualize import visualize_so3

    pred_rot = np.asarray(pred_rot)
    if energy is None:
        confidence = np.ones(pred_rot.shape[0]) / 200
    else:
        e = np.asarray(energy)[:, 0]
        confidence = np.exp(e - e.max())
        confidence = confidence / confidence.sum() / 10
    visualize_so3(save_path=save_path, pred_rotations=pred_rot, gt_rotation=gt_rot,
                  probabilities=confidence)
