"""genpose_tpu_torch/eval/draw.py against the JAX package's eval/draw.py
(which draws with cv2): pixel for pixel.

- ``thick_line`` against ``cv2.line(..., 2)`` on seeded segments: inside
  the frame, crossing its edges, far outside it, near vertical and near
  horizontal, zero length, one pixel long;
- ``draw_detections`` of both packages on the same frame, seeded poses
  and sizes (symmetric classes through ``align_rotation``, boxes and axes,
  the error-flag variant): the frames and the written PNGs equal, with
  objects placed so that some boxes leave the frame and an axis points
  along the viewing direction (a zero-length segment);
- the projections and the aligned rotations equal.
"""

import zlib

import cv2
import numpy as np
import pytest

from genpose_tpu.eval import draw as jdraw
from genpose_tpu_torch.data.nocs import REAL_INTRINSICS
from genpose_tpu_torch.eval import draw
from genpose_tpu_torch.utils import png

H, W = 120, 160


def _segments(kind, rng, n):
    if kind == "inside":
        p0, p1 = rng.integers(0, [W, H], (n, 2)), rng.integers(0, [W, H], (n, 2))
    elif kind == "crossing":
        p0, p1 = rng.integers(-60, [W + 60, H + 60], (n, 2)), rng.integers(-60, [W + 60, H + 60],
                                                                            (n, 2))
    elif kind == "far":
        p0, p1 = rng.integers(-3000, 3000, (n, 2)), rng.integers(-3000, 3000, (n, 2))
    elif kind == "near_vertical":
        p0 = rng.integers(-2, [W + 2, H + 2], (n, 2))
        p1 = p0 + np.stack([rng.integers(-2, 3, n), rng.integers(-200, 200, n)], 1)
    elif kind == "near_horizontal":
        p0 = rng.integers(-2, [W + 2, H + 2], (n, 2))
        p1 = p0 + np.stack([rng.integers(-200, 200, n), rng.integers(-2, 3, n)], 1)
    elif kind == "zero_length":
        p0 = rng.integers(-2, [W + 2, H + 2], (n, 2))
        p1 = p0.copy()
    else:  # one pixel long, at and beyond the edges
        p0 = rng.integers(-2, [W + 2, H + 2], (n, 2))
        p1 = p0 + rng.integers(-1, 2, (n, 2))
    return p0, p1


@pytest.mark.parametrize("kind", ["inside", "crossing", "far", "near_vertical",
                                  "near_horizontal", "zero_length", "short"])
def test_thick_line_equals_cv2(kind):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    p0s, p1s = _segments(kind, rng, 300)
    for p0, p1 in zip(p0s, p1s):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        want = np.zeros((H, W, 3), np.uint8)
        got = want.copy()
        cv2.line(want, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), color, 2)
        draw.thick_line(got, p0, p1, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} -> {p1}")


def _scene(rng, n, place):
    """n objects' sRT [n, 4, 4] and sizes [n, 3]; ``place`` picks the
    translations (in front of the camera, at the frame's edges, on the
    optical axis)."""
    sRT = np.zeros((n, 4, 4))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        sRT[i, :3, :3] = q * rng.uniform(0.1, 0.3)
        sRT[i, 3, 3] = 1
    if place == "front":
        sRT[:, :3, 3] = rng.uniform([-0.2, -0.15, 0.6], [0.2, 0.15, 1.2], (n, 3))
    elif place == "edges":
        sRT[:, :3, 3] = rng.uniform([-0.9, -0.7, 0.5], [0.9, 0.7, 0.8], (n, 3))
    else:  # on the optical axis, unrotated: the z axis projects to one pixel
        sRT[:, :3, :3] = np.eye(3) * 0.2
        cx, cy = REAL_INTRINSICS[0, 2], REAL_INTRINSICS[1, 2]
        fx, fy = REAL_INTRINSICS[0, 0], REAL_INTRINSICS[1, 1]
        z = rng.uniform(0.6, 1.0, n)
        sRT[:, :3, 3] = np.stack([(np.round(cx) - cx) * z / fx, (np.round(cy) - cy) * z / fy,
                                  z], 1)
    return sRT, rng.uniform(0.05, 0.3, (n, 3))


@pytest.mark.parametrize("place", ["front", "edges", "axis"])
@pytest.mark.parametrize("flags", [False, True], ids=["plain", "with_error"])
def test_draw_detections_equals_jax(tmp_path, place, flags):
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    pred, pred_size = _scene(rng, 4, place)
    gt, gt_size = _scene(rng, 3, place)
    nocs, nocs_size = _scene(rng, 2, place)
    kw = dict(intrinsics=REAL_INTRINSICS, pred_sRT=pred, pred_size=pred_size,
              pred_class_ids=np.array([1, 2, 3, 4]), gt_sRT=gt, gt_size=gt_size,
              gt_class_ids=np.array([4, 5, 6]), nocs_sRT=nocs, nocs_size=nocs_size,
              nocs_class_ids=np.array([2, 6]), draw_bbox=True,
              error_flags=np.array([True, False, True, False]) if flags else None)
    want_img, got_img = frame.copy(), frame.copy()
    want = jdraw.draw_detections(want_img, str(tmp_path / "jax"), "real", 3, **kw)
    got = draw.draw_detections(got_img, str(tmp_path / "port"), "real", 3, **kw)
    assert (want_img != frame).any()
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(png.imread(got), cv2.imread(want))  # both BGR
    assert got.endswith("real_3_pred.png")


def test_projections_and_alignment_equal_jax():
    rng = np.random.default_rng(3)
    sRT, size = _scene(rng, 5, "front")
    for m in sRT:
        np.testing.assert_array_equal(draw.align_rotation(m), jdraw.align_rotation(m))
    pts = rng.uniform([-0.3, -0.3, 0.5], [0.3, 0.3, 1.5], (40, 3)).T
    np.testing.assert_array_equal(draw.calculate_2d_projections(pts, REAL_INTRINSICS),
                                  jdraw.calculate_2d_projections(pts, REAL_INTRINSICS))
    np.testing.assert_array_equal(draw.get_3d_coord_axis(), jdraw.get_3d_coord_axis())
