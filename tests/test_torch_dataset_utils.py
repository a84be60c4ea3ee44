"""genpose_tpu_torch.data.dataset_utils and the synthetic NOCS tree against
the JAX package.

- The crop (``crop_resize_by_warp_affine``, nearest) equals the JAX
  package's, which calls ``cv2.warpAffine(..., INTER_NEAREST)``, pixel for
  pixel over 240 boxes: the eval path's square boxes and boxes whose
  centre and scale fall on half pixels, for the 2-channel coordinate map
  (OpenCV's fixed-point path) and 1- and 3-channel images (its float path).
- ``backproject_and_sample`` equals the JAX package's with its native host
  kernel, bit for bit, and leaves the generator in the same state.
- The port's synthetic tree equals the JAX generator's for the same seed.

Exact equality throughout: every function here is integer or float32
arithmetic in a fixed order on both sides.
"""

import os
import pickle

import cv2
import numpy as np
import pytest

from genpose_tpu import native
from genpose_tpu.data import dataset_utils as jdu
from genpose_tpu.data import synthetic as jsyn
from genpose_tpu_torch.data import dataset_utils as tdu
from genpose_tpu_torch.data import synthetic as tsyn

H, W = 480, 640
REAL_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32)


def _images(rng):
    depth = (rng.integers(300, 1500, (H, W)) * (rng.random((H, W)) > 0.2)).astype(np.float32)
    return {
        "coord_2ch": tdu.get_2d_coord_np(W, H).transpose(1, 2, 0),
        "mask_1ch": (rng.random((H, W)) > 0.5).astype(np.float32),
        "depth_1ch": depth,
        "bgr_3ch": rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
    }


def _boxes(rng, n):
    """n (center, scale, output size): half of them the eval path's boxes
    (a detection's roi -> ``get_bbox`` -> ``aug_bbox_eval``), half with
    centre and scale on quarter and half pixels."""
    out = []
    for i in range(n):
        size = int(rng.choice([256, 224, 64, 37]))
        if i % 2 == 0:
            y1, x1 = int(rng.integers(0, H - 20)), int(rng.integers(0, W - 20))
            y2 = min(H - 1, y1 + int(rng.integers(10, 300)))
            x2 = min(W - 1, x1 + int(rng.integers(10, 300)))
            rmin, rmax, cmin, cmax = jdu.get_bbox((y1, x1, y2, x2), H, W)
            center, scale = jdu.aug_bbox_eval((cmin, rmin, cmax, rmax), H, W)
        else:
            center = rng.integers(-20, [W + 20, H + 20]) + rng.choice([0, 0.25, 0.5], 2)
            scale = float(rng.integers(8, 900)) + float(rng.choice([0, 0.5]))
        out.append((center, scale, size))
    return out


def test_crop_equals_cv2_warp_pixel_for_pixel():
    rng = np.random.default_rng(0)
    images = _images(rng)
    boxes = _boxes(rng, 240)
    for n, (center, scale, size) in enumerate(boxes):
        for name, img in images.items():
            want = jdu.crop_resize_by_warp_affine(img, center, scale, size,
                                                  interpolation=cv2.INTER_NEAREST)
            got = tdu.crop_resize_by_warp_affine(img, center, scale, size)
            assert got.dtype == want.dtype and got.shape == want.shape, (n, name)
            assert np.array_equal(got, want), (n, name, center, scale, size)


def test_affine_transform_equals_cv2_solve():
    rng = np.random.default_rng(1)
    for center, scale, size in _boxes(rng, 60):
        for inv in (False, True):
            want = jdu.get_affine_transform(center, (scale, scale), 0, (size, size), inv=inv)
            got = tdu.get_affine_transform(center, (scale, scale), 0, (size, size), inv=inv)
            assert np.array_equal(got, want)


def test_warp_of_a_general_matrix_equals_cv2():
    """Rotation, shear and a rectangular output, beyond the eval crops."""
    rng = np.random.default_rng(2)
    img = _images(rng)["depth_1ch"]
    coord = tdu.get_2d_coord_np(W, H, "HWC")
    for _ in range(20):
        M = rng.normal(size=(2, 3))
        M[:, 2] *= 100
        w, h = (int(v) for v in rng.integers(1, 300, 2))
        for src in (img, np.ascontiguousarray(coord)):
            want = cv2.warpAffine(src, M, (w, h), flags=cv2.INTER_NEAREST)
            assert np.array_equal(tdu.warp_affine_nearest(src, M, (w, h)), want)


def _roi(rng, size, valid_frac):
    depth = (rng.integers(300, 1500, (1, size, size))
             * (rng.random((1, size, size)) < valid_frac)).astype(np.float32)
    mask = (rng.random((1, size, size)) > 0.3).astype(np.float32)
    coord = (tdu.get_2d_coord_np(size, size) + rng.integers(0, 300, (2, 1, 1))).astype(np.float32)
    return depth, mask, coord


@pytest.mark.parametrize("size, valid_frac, n_pts", [
    (64, 0.9, 1024),   # fewer valid points than n_pts: tiled
    (128, 0.9, 1024),  # more: partial Fisher-Yates with the kernel's stream
    (256, 0.5, 128),
    (32, 0.0, 64),     # no valid point
    (8, 1.0, 1),
], ids=["tile", "sample", "sample_many", "empty", "one"])
def test_backproject_and_sample_equals_native_kernel(size, valid_frac, n_pts):
    assert native.available(), "the JAX package's host kernel did not build"
    depth, mask, coord = _roi(np.random.default_rng(size), size, valid_frac)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        want = jdu.backproject_and_sample(depth, REAL_K, coord, mask, n_pts, jrng, scale=1e-3)
        got = tdu.backproject_and_sample(depth, REAL_K, coord, mask, n_pts, trng, scale=1e-3)
        assert got[0] == want[0]
        assert got[1].dtype == np.float32 and got[1].shape == (n_pts, 3)
        assert np.array_equal(got[1], want[1])
    assert jrng.integers(0, 2**63 - 1) == trng.integers(0, 2**63 - 1)


def test_xorshift_stream_equals_the_kernel_on_edge_seeds():
    """Seeds at the ends of the uint64 range and the bound n = 2^32 + 1,
    where a float product or a 64-bit overflow would show."""
    assert native.available()
    pcl = np.arange(3 * 5000, dtype=np.float32).reshape(5000, 3)
    for seed in (0, 1, 2**63 - 2, 2**64 - 1, 0x9E3779B97F4A7C15):
        want = native.sample_points(pcl, 700, seed)
        got = tdu._native_sample(pcl, 700, seed)
        assert np.array_equal(got, want), seed
    draws = tdu._xorshift_draws(12345, [2**32 + 1, 2**63, 1])
    assert all(0 <= d < n for d, n in zip(draws, [2**32 + 1, 2**63, 1]))


def test_numpy_helpers_equal_jax():
    rng = np.random.default_rng(3)
    for fmt in ("CHW", "HWC"):
        assert np.array_equal(tdu.get_2d_coord_np(40, 30, fmt), jdu.get_2d_coord_np(40, 30, fmt))
    for _ in range(50):
        y1, x1 = rng.integers(0, 400), rng.integers(0, 600)
        box = (y1, x1, y1 + rng.integers(1, 500), x1 + rng.integers(1, 500))
        assert tdu.get_bbox(box) == jdu.get_bbox(box)
        c1, s1 = tdu.aug_bbox_eval(box, H, W)
        c2, s2 = jdu.aug_bbox_eval(box, H, W)
        assert np.array_equal(c1, c2) and s1 == s2
    depth, mask, coord = _roi(rng, 64, 0.7)
    pcl = tdu.depth_to_pcl(depth, REAL_K, coord, mask)
    assert np.array_equal(pcl, jdu.depth_to_pcl(depth, REAL_K, coord, mask))
    for n in (0, 10, len(pcl)):
        a = tdu.sample_points(pcl[:n], 100, np.random.default_rng(4))
        assert np.array_equal(a, jdu.sample_points(pcl[:n], 100, np.random.default_rng(4)))


@pytest.mark.parametrize("kind", ["uint16", "bgr8"])
def test_load_depth_equals_jax(tmp_path, kind):
    """A 16-bit depth as the JAX package reads it.  A 3-channel CAMERA depth
    is G * 256 + R in 16 bits, as the reference computes it under numpy 1
    (the JAX package's ``depth[:, :, 1] * 256`` raises under numpy 2), so
    that case is held against the formula on ``cv2.imread``'s array."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "0000_depth.png")
    if kind == "uint16":
        cv2.imwrite(path, rng.integers(0, 5000, (48, 64)).astype(np.uint16))
        want = jdu.load_depth(str(tmp_path / "0000"))
    else:  # high byte in G, low byte in R, 32001 = no depth
        img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        img[0, :3, 1], img[0, :3, 2] = 32001 // 256, 32001 % 256
        cv2.imwrite(path, img)
        bgr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        want = bgr[:, :, 1].astype(np.uint16) * 256 + bgr[:, :, 2]
        want[want == 32001] = 0
    got = tdu.load_depth(str(tmp_path / "0000"))
    assert got.dtype == want.dtype == np.uint16
    assert np.array_equal(got, want)
    if kind == "bgr8":
        assert (got[0, :3] == 0).all() and (got > 256).any()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    kw = dict(n_camera_scenes=1, n_real_scenes=2, seed=11)
    jroot = jsyn.make_synthetic_nocs_dir(str(root / "jax"), **kw)
    troot = tsyn.make_synthetic_nocs_dir(str(root / "port"), **kw)
    for tracking in (False, True):
        sub = "track" if tracking else "flat"
        jsyn.make_synthetic_mrcnn_results(jroot, str(root / f"jres_{sub}"), tracking=tracking)
        tsyn.make_synthetic_mrcnn_results(troot, str(root / f"tres_{sub}"), tracking=tracking)
    return root


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) for f in fs)


def _assert_same_pickles(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        x, y = pickle.load(fa), pickle.load(fb)

    def same(u, v):
        if isinstance(u, dict):
            assert isinstance(v, dict) and list(u) == list(v)
            for k in u:
                same(u[k], v[k])
        elif isinstance(u, np.ndarray):
            assert isinstance(v, np.ndarray) and u.dtype == v.dtype
            assert np.array_equal(u, v)
        else:
            assert type(u) is type(v) and u == v

    same(x, y)


def test_synthetic_tree_equals_jax(trees):
    jroot, troot = trees / "jax", trees / "port"
    names = _files(jroot)
    assert names == _files(troot) and len(names) > 20
    for name in names:
        a, b = str(jroot / name), str(troot / name)
        if name.endswith(".png"):
            want = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            assert np.array_equal(tdu.png.imread(b, unchanged=True), want), name
            assert np.array_equal(cv2.imread(b, cv2.IMREAD_UNCHANGED), want), name
        elif name.endswith(".pkl"):
            _assert_same_pickles(a, b)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), name


@pytest.mark.parametrize("layout", ["flat", "track"])
def test_synthetic_mrcnn_results_equal_jax(trees, layout):
    jdir = trees / f"jres_{layout}" / "mrcnn_results" / "real_test"
    tdir = trees / f"tres_{layout}" / "mrcnn_results" / "real_test"
    names = _files(jdir)
    assert names == _files(tdir) and len(names) == 2
    for name in names:
        _assert_same_pickles(str(jdir / name), str(tdir / name))
