"""Host-side image utilities of the training and evaluation data
(counterpart of ``genpose_tpu/data/dataset_utils.py``), without OpenCV.

- ``get_2d_coord_np``, ``aug_bbox_DZI``, ``aug_bbox_eval``, ``get_bbox``,
  ``depth_to_pcl``, ``sample_points``: numpy copies of the JAX package's
  functions; ``aug_bbox_DZI`` draws from the caller's ``np.random.Generator``
  in the JAX order.
- ``get_affine_transform``: the CenterNet crop transform, solved from three
  point pairs as ``cv2.getAffineTransform`` does (6x6 Gaussian elimination
  with partial pivoting in double; bit for bit).
- ``crop_resize_by_warp_affine``: ``cv2.warpAffine`` with ``INTER_NEAREST``
  and a zero border, pixel for pixel as OpenCV 5.0 picks them: the matrix
  is inverted in double; a 2-channel image goes through fixed-point source
  coordinates (each term rounded to 1/1024 of a pixel, ``AB_BITS = 10``,
  then ``(v + 512) >> 10``: half up), other images through float32
  coordinates with a fused multiply-add, rounded half to even.  The two
  rules part where a coordinate falls on .5, which eval crops hit often.
- ``load_depth``: a depth PNG through ``utils/png.py``; a 3-channel depth
  is ``G * 256 + R`` (cv2's BGR indexing ``[:, :, 1] * 256 + [:, :, 2]``).
- ``backproject_and_sample``: the host C helper (``native/``, the port's
  copy of ``genpose_tpu/native/preprocess.cpp``) on one instance:
  float32 back-projection, one ``rng.integers(0, 2**63 - 1)`` seed per
  call, then xorshift128+ seeded by splitmix64, a Lemire multiply-high draw
  and a partial Fisher-Yates.  The same ``np.random.Generator`` state gives
  the JAX package's cloud, bit for bit.  ``backproject_and_sample_ref`` is
  its plain version in numpy and Python integers (the tests' oracle, and
  the path under ``GENPOSE_NO_NATIVE``).

- ``defor_2D``: the training mask's boundary noise as the JAX package's
  cv2 calls compute it.  ``cv2.erode(mask, kernel, rand_r)`` puts
  ``rand_r`` in the ``dst`` slot, so ONE iteration runs, with cv2's 2x2
  ellipse ``[[0, 1], [1, 1]]`` anchored at its centre (1, 1): a pixel's
  erosion (dilation) is the min (max) of itself and its upper and left
  neighbours, and a neighbour outside the image counts as nothing (cv2's
  default border value for both).
"""

from __future__ import annotations

import functools

import numpy as np

from genpose_tpu_torch import native
from genpose_tpu_torch.utils import png

@functools.lru_cache(maxsize=8)
def _coord_map_cached(width: int, height: int, fmt: str) -> np.ndarray:
    x = np.linspace(0, width - 1, width, dtype=np.float32)
    y = np.linspace(0, height - 1, height, dtype=np.float32)
    xy = np.asarray(np.meshgrid(x, y))
    if fmt == "HWC":
        xy = xy.transpose(1, 2, 0)
    elif fmt != "CHW":
        raise ValueError(f"Unknown format: {fmt}")
    xy.setflags(write=False)
    return xy


def get_2d_coord_np(width: int, height: int, fmt: str = "CHW") -> np.ndarray:
    """Pixel-coordinate map [2, H, W] (or [H, W, 2]); cached and read-only."""
    return _coord_map_cached(width, height, fmt)


def aug_bbox_DZI(dzi_params, bbox_xyxy, im_H, im_W, rng: np.random.Generator):
    """Dynamic-zoom-in bbox jitter (ref ``datasets_utils.py:25-62``):
    ``dzi_type`` ``uniform``, ``roi10d`` or anything else (no jitter).
    Returns (bbox_center [2], scale)."""
    x1, y1, x2, y2 = np.asarray(bbox_xyxy, dtype=np.float64).copy()
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bh, bw = y2 - y1, x2 - x1
    dzi_type = dzi_params.dzi_type.lower()
    if dzi_type == "uniform":
        scale_ratio = 1 + dzi_params.scale_ratio * (2 * rng.random() - 1)
        shift_ratio = dzi_params.shift_ratio * (2 * rng.random(2) - 1)
        bbox_center = np.array([cx + bw * shift_ratio[0], cy + bh * shift_ratio[1]])
        scale = max(y2 - y1, x2 - x1) * scale_ratio * dzi_params.pad_scale
    elif dzi_type == "roi10d":
        _a, _b = -0.15, 0.15
        x1 += bw * (rng.random() * (_b - _a) + _a)
        x2 += bw * (rng.random() * (_b - _a) + _a)
        y1 += bh * (rng.random() * (_b - _a) + _a)
        y2 += bh * (rng.random() * (_b - _a) + _a)
        x1, x2 = np.clip([x1, x2], 0, im_W)
        y1, y2 = np.clip([y1, y2], 0, im_H)
        bbox_center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
        scale = max(y2 - y1, x2 - x1) * dzi_params.pad_scale
    else:
        bbox_center = np.array([cx, cy])
        scale = max(y2 - y1, x2 - x1)
    scale = min(scale, max(im_H, im_W)) * 1.0
    return bbox_center, scale


def aug_bbox_eval(bbox_xyxy, im_H, im_W):
    """Deterministic eval-time square bbox (ref ``datasets_utils.py:65-80``)."""
    x1, y1, x2, y2 = np.asarray(bbox_xyxy, dtype=np.float64)
    bbox_center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
    scale = max(y2 - y1, x2 - x1)
    scale = min(scale, max(im_H, im_W)) * 1.0
    return bbox_center, scale


def _get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ]


def _get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 map taking three float32 points ``src`` to ``dst``
    (``cv2.getAffineTransform``): the 6x6 system solved in double by
    elimination with partial pivoting, in OpenCV's operation order."""
    a, b = [], []
    for (x, y), (u, v) in zip(np.float32(src).tolist(), np.float32(dst).tolist()):
        a += [[x, y, 1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, x, y, 1.0]]
        b += [u, v]
    n = 6
    for i in range(n):
        k = max(range(i, n), key=lambda j: (abs(a[j][i]), -j))  # first largest pivot
        if abs(a[k][i]) < np.finfo(np.float64).eps * 100:
            return np.zeros((2, 3))  # singular: cv2 returns zeros
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, n):
            alpha = a[j][i] * d
            for c in range(i + 1, n):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(n - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, n):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=False):
    """CenterNet-style crop transform (ref ``datasets_utils.py:97-138``)."""
    center = np.asarray(center, dtype=np.float32)
    if isinstance(scale, (int, float)):
        scale = np.array([scale, scale], dtype=np.float32)
    if isinstance(output_size, (int, float)):
        output_size = (output_size, output_size)

    src_w = scale[0]
    dst_w, dst_h = output_size

    rot_rad = np.pi * rot / 180
    src_dir = _get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale * shift
    src[1, :] = center + src_dir + scale * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2:, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = _get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


_AB_BITS = 10
_I32 = (-2 ** 31, 2 ** 31 - 1)


def _round_int(v: np.ndarray) -> np.ndarray:
    """cv2's ``saturate_cast<int>``: round half to even, clamped to int32."""
    return np.clip(np.rint(v), *_I32).astype(np.int64)


def _invert_affine(M) -> list:
    """The inverse of a 2x3 map in double, in ``cv2.warpAffine``'s order."""
    m = np.asarray(M, np.float64).reshape(6).tolist()
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    m[0], m[1], m[3], m[4] = a11, m[1] * -D, m[3] * -D, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m


def _fma_f32(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add a * b + c, rounded once.  The float32
    product is exact in double; the sum's rounding error (TwoSum) decides a
    round-to-odd double, whose rounding to float32 is then the correct one."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd_fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(odd_fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _source_pixels_fixed(m, w: int, h: int):
    """OpenCV's generic path: each term rounded to 1/1024 of a pixel
    (``AB_BITS = 10``), the coordinate rounded half up by ``(v + 512) >> 10``."""
    scale, half = 1 << _AB_BITS, 1 << (_AB_BITS - 1)
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    adelta, bdelta = _round_int(m[0] * xs * scale), _round_int(m[3] * xs * scale)
    x0 = _round_int((m[1] * ys + m[2]) * scale) + half
    y0 = _round_int((m[4] * ys + m[5]) * scale) + half
    return (x0[:, None] + adelta[None, :]) >> _AB_BITS, (y0[:, None] + bdelta[None, :]) >> _AB_BITS


def _source_pixels_f32(m, w: int, h: int):
    """OpenCV 5's vector path for 1, 3 and 4 channels: the inverse map cast
    to float32, x * m0 + (y * m1 + m2) with the outer multiply-add fused,
    rounded half to even."""
    f = [np.float32(v) for v in m]
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = _fma_f32(xs, f[0], ys * f[1] + f[2])
    sy = _fma_f32(xs, f[3], ys * f[4] + f[5])
    return _round_int(sx), _round_int(sy)


def warp_affine_nearest(img: np.ndarray, M: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=INTER_NEAREST)`` with the
    default constant border of zeros, as OpenCV 5.0 computes it.  img
    [H, W] or [H, W, C]; dsize (w, h).

    OpenCV inverts M in double.  For 2-channel images (the pixel-coordinate
    map) it takes the generic fixed-point path; for 1, 3 and 4 channels
    (mask, depth, colour) its float32 vector path.  The two pick different
    pixels where a source coordinate falls on .5, so both are kept."""
    w, h = int(dsize[0]), int(dsize[1])
    m = _invert_affine(M)
    channels = img.shape[2] if img.ndim == 3 else 1
    X, Y = (_source_pixels_fixed if channels == 2 else _source_pixels_f32)(m, w, h)
    H, W = img.shape[:2]
    inside = (X >= 0) & (X < W) & (Y >= 0) & (Y < H)
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    out[inside] = img[Y[inside], X[inside]]
    return out


def crop_resize_by_warp_affine(img, center, scale, output_size, rot=0):
    """Square crop + resize by nearest neighbour (ref ``datasets_utils.py:82-95``
    with ``interpolation=cv2.INTER_NEAREST``, the one the eval path uses)."""
    if isinstance(scale, (int, float)):
        scale = (scale, scale)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    trans = get_affine_transform(center, scale, rot, output_size)
    return warp_affine_nearest(img, trans, (int(output_size[0]), int(output_size[1])))


def load_depth(img_path: str) -> np.ndarray:
    """16-bit depth decode (ref ``sgpa_utils.py:194-211``)."""
    depth_path = img_path if img_path.endswith(".png") else img_path + "_depth.png"
    depth = png.imread(depth_path, unchanged=True)
    if len(depth.shape) == 3:
        depth16 = depth[:, :, 1].astype(np.uint16) * 256 + depth[:, :, 2]
        depth16 = np.where(depth16 == 32001, 0, depth16)
        depth16 = depth16.astype(np.uint16)
    elif len(depth.shape) == 2 and depth.dtype == np.uint16:
        depth16 = depth
    else:
        raise ValueError("[ Error ]: Unsupported depth type.")
    return depth16


def get_bbox(bbox, img_width: int = 480, img_length: int = 640):
    """Square crop window snapped to 40px multiples (ref ``sgpa_utils.py:214-242``)."""
    y1, x1, y2, x2 = bbox
    window_size = (max(y2 - y1, x2 - x1) // 40 + 1) * 40
    window_size = min(window_size, 440)
    center = [(y1 + y2) // 2, (x1 + x2) // 2]
    rmin = center[0] - int(window_size / 2)
    rmax = center[0] + int(window_size / 2)
    cmin = center[1] - int(window_size / 2)
    cmax = center[1] + int(window_size / 2)
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_width:
        rmin -= rmax - img_width
        rmax = img_width
    if cmax > img_length:
        cmin -= cmax - img_length
        cmax = img_length
    return rmin, rmax, cmin, cmax


def depth_to_pcl(depth, K, xymap, mask) -> np.ndarray:
    """Back-project masked depth to a camera-frame point cloud
    (ref ``datasets_genpose.py:386-397``).  Units follow the input depth."""
    K = np.asarray(K).reshape(-1)
    cx, cy, fx, fy = K[2], K[5], K[0], K[4]
    depth = depth.reshape(-1).astype(np.float32)
    valid = ((depth > 0) * mask.reshape(-1)) > 0
    depth = depth[valid]
    x_map = xymap[0].reshape(-1)[valid]
    y_map = xymap[1].reshape(-1)[valid]
    real_x = (x_map - cx) * depth / fx
    real_y = (y_map - cy) * depth / fy
    return np.stack((real_x, real_y, depth), axis=-1).astype(np.float32)


def sample_points(pcl: np.ndarray, n_pts: int, rng: np.random.Generator) -> np.ndarray:
    """Random down/duplicate-sample to exactly n_pts (ref
    ``datasets_genpose.py:370-383``; the JAX package's numpy fallback)."""
    total = pcl.shape[0]
    if total == 0:
        return np.zeros((n_pts, 3), dtype=np.float32)
    if total < n_pts:
        pcl = np.concatenate(
            [np.tile(pcl, (n_pts // total, 1)), pcl[: n_pts % total]], axis=0
        )
    elif total > n_pts:
        ids = rng.permutation(total)[:n_pts]
        pcl = pcl[ids]
    return pcl


# ---------------------------------------------------------------------------
# the host C helper's sampler (native/preprocess.cpp), in Python integers:
# the plain version of its stream
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, z ^ (z >> 31)


def _xorshift_draws(seed: int, bounds) -> list:
    """``gp_rng_below(rng, n)`` for each n of ``bounds``, from one stream:
    xorshift128+ seeded by two splitmix64 outputs, and (x * n) >> 64."""
    state, s0 = _splitmix64(seed & _M64)
    _, s1 = _splitmix64(state)
    if s0 == 0 and s1 == 0:
        s1 = 1
    out = []
    for n in bounds:
        x, y = s0, s1
        s0 = y
        x = (x ^ (x << 23)) & _M64
        s1 = x ^ y ^ (x >> 17) ^ (y >> 26)
        out.append((((s1 + y) & _M64) * n) >> 64)
    return out


def _native_sample(pcl: np.ndarray, n_pts: int, seed: int) -> np.ndarray:
    """``gp_sample_points``: tile a short cloud, partial Fisher-Yates a long one."""
    n = pcl.shape[0]
    if n == 0:
        return np.zeros((n_pts, 3), np.float32)
    if n <= n_pts:
        reps = -(-n_pts // n)
        return np.tile(pcl, (reps, 1))[:n_pts].copy()
    idx = list(range(n))
    picks = []
    for i, r in enumerate(_xorshift_draws(seed, range(n, n - n_pts, -1))):
        j = i + r
        idx[i], idx[j] = idx[j], idx[i]
        picks.append(idx[i])
    return pcl[np.asarray(picks, np.int64)]


def _intrinsics(K, scale):
    f32 = np.float32
    Kf = np.asarray(K).reshape(-1)
    return f32(Kf[0]), f32(Kf[4]), f32(Kf[2]), f32(Kf[5]), f32(scale)


def backproject_and_sample(depth, K, xymap, mask, n_pts: int,
                           rng: np.random.Generator, scale: float = 1.0):
    """Masked back-projection + sampling of one instance through the host C
    helper (``native.backproject_sample``), as the JAX package's
    ``dataset_utils.py:214-241`` calls its copy: one seed drawn from ``rng``
    first, the float32 intrinsics.  Returns ``(n_valid, pcl [n_pts, 3]
    float32)``.  With ``GENPOSE_NO_NATIVE`` set, the plain version
    ``backproject_and_sample_ref`` computes the same arrays."""
    if native.disabled():
        return backproject_and_sample_ref(depth, K, xymap, mask, n_pts, rng, scale)
    fx, fy, cx, cy, s = _intrinsics(K, scale)
    seed = int(rng.integers(0, 2**63 - 1))
    return native.backproject_sample(depth, mask, xymap[0], xymap[1], fx, fy, cx, cy, s,
                                     n_pts, seed)


def depth_mask_to_pcl_ref(depth, mask, xmap, ymap, fx, fy, cx, cy, scale=1.0) -> np.ndarray:
    """Plain version of ``native.depth_mask_to_pcl``: the (n_valid, 3) cloud
    of the pixels with depth > 0 and mask > 0, in float32 and the helper's
    order ``(x - cx) * d * (scale / fx)``."""
    f32 = np.float32
    fx, fy, cx, cy, s = (f32(v) for v in (fx, fy, cx, cy, scale))
    d = np.ascontiguousarray(depth, f32).ravel()
    m = np.ascontiguousarray(mask, f32).ravel()
    valid = (d > 0) & (m > 0)
    d = d[valid]
    xm = np.ascontiguousarray(xmap, f32).ravel()[valid]
    ym = np.ascontiguousarray(ymap, f32).ravel()[valid]
    inv_fx, inv_fy = s / fx, s / fy
    return np.stack([(xm - cx) * d * inv_fx, (ym - cy) * d * inv_fy, d * s], axis=-1)


def backproject_and_sample_ref(depth, K, xymap, mask, n_pts: int,
                               rng: np.random.Generator, scale: float = 1.0):
    """Plain version of ``backproject_and_sample`` in numpy and Python
    integers (the helper's ``gp_backproject_sample``):
    ``depth_mask_to_pcl_ref``, then ``_native_sample``'s stream.  The same
    ``rng`` state gives the same cloud, bit for bit."""
    fx, fy, cx, cy, s = _intrinsics(K, scale)
    seed = int(rng.integers(0, 2**63 - 1))
    pcl = depth_mask_to_pcl_ref(depth, mask, xymap[0], xymap[1], fx, fy, cx, cy, s)
    return pcl.shape[0], _native_sample(pcl, n_pts, seed)


def _erode_dilate_2x2(mask: np.ndarray):
    """``cv2.erode`` and ``cv2.dilate`` of a 2-D mask by the 2x2 ellipse
    ``[[0, 1], [1, 1]]``, one iteration, default anchor and border: each
    pixel against itself, the pixel above and the pixel to its left, a
    neighbour outside the image ignored."""
    up_lo, left_lo = mask.copy(), mask.copy()  # outside: the pixel itself, neutral
    up_lo[1:], left_lo[:, 1:] = mask[:-1], mask[:, :-1]
    return (np.minimum(np.minimum(up_lo, left_lo), mask),
            np.maximum(np.maximum(up_lo, left_lo), mask))


def defor_2D(roi_mask, rng: np.random.Generator, rand_r=2, rand_pro=0.3):
    """Random mask erode/dilate boundary noise (ref ``data_augmentation.py:10-33``),
    as the JAX package's cv2 calls compute it (module docstring): with
    probability ``rand_pro`` half of the pixels where erosion and dilation
    differ, drawn without replacement, are cleared and the rest set.
    ``rand_r`` is accepted and, as there, changes nothing."""
    roi_mask = roi_mask.copy().squeeze()
    if rng.random() > rand_pro:
        return roi_mask
    mask_erode, mask_dilate = _erode_dilate_2x2(roi_mask)
    edge = mask_erode != mask_dilate
    change_list = roi_mask[edge]
    if change_list.size < 1:
        return roi_mask
    choose = rng.choice(change_list.size, change_list.size // 2, replace=False)
    change_list = np.ones_like(change_list)
    change_list[choose] = 0.0
    roi_mask[edge] = change_list
    roi_mask[roi_mask > 0.0] = 1.0
    return roi_mask
