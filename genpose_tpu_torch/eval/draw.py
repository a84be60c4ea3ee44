"""Detection drawing: 3-D box and coordinate-axis overlays on BGR frames
(counterpart of ``genpose_tpu/eval/draw.py``; reference
``utils/sgpa_utils.py:1253-1463``).

Numpy only.  Every segment is drawn as ``cv2.line(img, p0, p1, color, 2)``
draws it, pixel for pixel (``thick_line``, held against OpenCV 5.0): the
segment clipped to the frame grown by the thickness on every side, then a
filled quadrilateral one thickness wide (``_fill_convex_poly``, its edges
traced by ``_line2``, all in 16.16 fixed point) and a filled circle of
radius 1 at each end (``_circle``).  The frame is written by
``utils/png.py``.  As in the JAX package, nothing calls these functions.
"""

from __future__ import annotations

import math
import os

import numpy as np

from genpose_tpu_torch.eval.nocs_eval import get_3d_bbox, transform_coordinates_3d
from genpose_tpu_torch.utils import png

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
DBL_EPSILON = 2.220446049250313e-16


def get_3d_coord_axis() -> np.ndarray:
    """Origin + 0.1 m x/y/z axis endpoints, [3, 4] (ref ``sgpa_utils.py:281``)."""
    return np.array([[0, 0, 0], [0, 0, 0.1], [0, 0.1, 0], [0.1, 0, 0]],
                    dtype=np.float64).transpose()


def calculate_2d_projections(coordinates_3d, intrinsics) -> np.ndarray:
    """[3, N] camera-frame points -> [N, 2] int pixel coordinates
    (ref ``sgpa_utils.py:1253-1268``)."""
    proj = intrinsics @ coordinates_3d
    proj = (proj[:2, :] / proj[2, :]).transpose()
    return np.array(proj, dtype=np.int32)


def align_rotation(sRT: np.ndarray) -> np.ndarray:
    """Rotate a symmetric object's pose so that its x-z heading is canonical
    (ref ``sgpa_utils.py:1271-1290``)."""
    s = np.cbrt(np.linalg.det(sRT[:3, :3]))
    R = sRT[:3, :3] / s
    T = sRT[:3, 3]
    theta_x = R[0, 0] + R[2, 2]
    theta_y = R[0, 2] - R[2, 0]
    r_norm = np.sqrt(theta_x ** 2 + theta_y ** 2)
    s_map = np.array([[theta_x / r_norm, 0.0, -theta_y / r_norm],
                      [0.0, 1.0, 0.0],
                      [theta_y / r_norm, 0.0, theta_x / r_norm]])
    aligned = np.identity(4, dtype=np.float32)
    aligned[:3, :3] = s * (R @ s_map)
    aligned[:3, 3] = T
    return aligned


# ---------------------------------------------------------------------------
# OpenCV's thick LINE_8 line, in integer arithmetic as OpenCV computes it
# ---------------------------------------------------------------------------

def _div_trunc(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a [0, width) x [0, height) frame; None when
    nothing is left."""
    right, bottom = width - 1, height - 1

    def code(x, y, with_y=True):
        c = (x < 0) + (x > right) * 2
        return c + ((y < 0) * 4 + (y > bottom) * 8 if with_y else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _line2(img, p1, p2, color) -> None:
    """OpenCV's ``Line2``, the outline ``FillConvexPoly`` traces: an
    8-connected line between two 16.16 fixed-point points, clipped to the
    frame in fixed point, one pixel per step of the major axis."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:  # walk in +x
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _div_trunc(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:  # walk in +y
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _div_trunc(dx * XY_ONE, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    pts = [((x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT)]
    x1, y1 = x1 + half, y1 + half
    if ax > ay:
        x = x1 >> XY_SHIFT
        for _ in range(ecount + 1):
            pts.append((x, y1 >> XY_SHIFT))
            x, y1 = x + 1, y1 + step
    else:
        y = y1 >> XY_SHIFT
        for _ in range(ecount + 1):
            pts.append((x1 >> XY_SHIFT, y))
            x1, y = x1 + step, y + 1
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _fill_convex_poly(img, v, color) -> None:
    """OpenCV's ``FillConvexPoly`` for LINE_8 at shift 16: the edges traced
    by ``_line2``, then each row between the left and right edge filled."""
    h, w = img.shape[:2]
    n = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while True:
                    go = edges > 0
                    edges -= 1
                    if not go:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _div_trunc((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"], e["idx"] = xs, idx
                        break
                    idx0, idx = idx, (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle(img, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (the midpoint algorithm), clipped."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img: np.ndarray, pt0, pt1, color, thickness: int = 2) -> np.ndarray:
    """``cv2.line(img, pt0, pt1, color, thickness)`` (LINE_8, integer
    points) in place, for thickness > 1: the segment clipped (``clipLine``)
    to the frame grown by ``thickness``, then OpenCV's ``ThickLine``."""
    if thickness < 2:
        raise ValueError("thick_line draws lines of thickness 2 or more")
    color = np.asarray(color, np.uint8).reshape(-1)
    color = color[: img.shape[2]] if img.ndim == 3 else color[0]
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, int(pt0[0]) + t, int(pt0[1]) + t,
                         int(pt1[0]) + t, int(pt1[1]) + t)
    if clipped is None:
        return img
    x0, y0, x1, y1 = (c - t for c in clipped)
    p0 = (x0 << XY_SHIFT, y0 << XY_SHIFT)
    p1 = (x1 << XY_SHIFT, y1 << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > DBL_EPSILON:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)], color)
    for p in (p0, p1):  # round caps
        _circle(img, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                (half + (XY_ONE >> 1)) >> XY_SHIFT, color)
    return img


# ---------------------------------------------------------------------------
# the overlays
# ---------------------------------------------------------------------------

def draw_bboxes(img, img_pts, color):
    """Wireframe box: dark ground layer, dimmer pillars, bright top
    (ref ``sgpa_utils.py:1325-1339``)."""
    img_pts = np.int32(img_pts).reshape(-1, 2)
    ground = tuple(int(c * 0.3) for c in color)
    for i, j in zip([4, 5, 6, 7], [5, 7, 4, 6]):
        img = thick_line(img, img_pts[i], img_pts[j], ground)
    pillar = tuple(int(c * 0.6) for c in color)
    for i, j in zip(range(4), range(4, 8)):
        img = thick_line(img, img_pts[i], img_pts[j], pillar)
    for i, j in zip([0, 1, 2, 3], [1, 3, 0, 2]):
        img = thick_line(img, img_pts[i], img_pts[j], tuple(color))
    return img


def draw_coord_axis(img, img_pts, correct: bool = True):
    """RGB axis triplet; all blue when flagged incorrect (ref
    ``sgpa_utils.py:1293-1322``)."""
    img_pts = np.int32(img_pts).reshape(-1, 2)
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255)] if correct else [(0, 0, 255)] * 3
    for k in range(3):
        img = thick_line(img, img_pts[0], img_pts[k + 1], colors[k])
    return img


def _draw_group(img, sRT_all, size_all, class_ids, intrinsics, color, draw_bbox, draw_axis,
                flags=None):
    for i in range(sRT_all.shape[0]):
        sRT = align_rotation(sRT_all[i]) if class_ids[i] in (1, 2, 4) else sRT_all[i]
        if draw_bbox:
            proj = calculate_2d_projections(
                transform_coordinates_3d(get_3d_bbox(size_all[i], 0), sRT), intrinsics)
            img = draw_bboxes(img, proj, color)
        if draw_axis:
            RT = sRT.copy()
            RT[:3, :3] = RT[:3, :3] / np.linalg.norm(RT[:3, 0])
            proj = calculate_2d_projections(
                transform_coordinates_3d(get_3d_coord_axis(), RT), intrinsics)
            img = draw_coord_axis(img, proj, correct=flags[i] if flags is not None else True)
    return img


def draw_detections(img, out_dir, data_name, img_id, intrinsics, pred_sRT, pred_size,
                    pred_class_ids, gt_sRT=None, gt_size=None, gt_class_ids=None,
                    nocs_sRT=None, nocs_size=None, nocs_class_ids=None, draw_gt=True,
                    draw_nocs=True, draw_pred=True, draw_axis=True, draw_bbox=False,
                    error_flags=None):
    """Overlay NOCS (blue boxes), GT (green) and predictions (red) on a BGR
    frame, in place, and write ``{data_name}_{img_id}_pred.png``
    (ref ``sgpa_utils.py:1342-1404``; with ``error_flags`` the
    ``draw_detections_with_error`` variant, ``:1406-1463``).  Returns the
    file's path."""
    out_path = os.path.join(out_dir, f"{data_name}_{img_id}_pred.png")
    if draw_nocs and nocs_sRT is not None:
        for i in range(nocs_sRT.shape[0]):
            sRT = (align_rotation(nocs_sRT[i]) if nocs_class_ids[i] in (1, 2, 4)
                   else nocs_sRT[i])
            proj = calculate_2d_projections(
                transform_coordinates_3d(get_3d_bbox(nocs_size[i], 0), sRT), intrinsics)
            img = draw_bboxes(img, proj, (255, 0, 0))
    if draw_gt and gt_sRT is not None:
        img = _draw_group(img, gt_sRT, gt_size, gt_class_ids, intrinsics, (0, 255, 0),
                          draw_bbox, draw_axis)
    if draw_pred and pred_sRT is not None:
        img = _draw_group(img, pred_sRT, pred_size, pred_class_ids, intrinsics, (0, 0, 255),
                          draw_bbox, draw_axis, flags=error_flags)
    os.makedirs(out_dir, exist_ok=True)
    png.imwrite(out_path, img)
    return out_path
