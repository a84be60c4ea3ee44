"""The port's host C helper (``genpose_tpu_torch/native``) against the JAX
package's copy (``genpose_tpu.native``) and against the port's plain versions.

The helper builds here with ``g++`` (the test fails if it cannot).  Every
entry point must equal, bit for bit:

- the JAX package's wrapper on the same inputs: ``depth_mask_to_pcl``,
  ``sample_points``, ``backproject_sample``, ``fps``;
- its plain version in the port: ``data/dataset_utils.py::
  depth_mask_to_pcl_ref``, ``_native_sample``, ``backproject_and_sample_ref``
  and ``ops/pointcloud.py::farthest_point_sample_ref``.

FPS against the JAX package's helper runs on clouds whose coordinates are
multiples of 1/64 (and those tiled): every difference, square and sum is
then exact in float32, and the grid gives many exactly tied distances.  On
other clouds the two helpers may part: the JAX package builds with
``-march=native`` and its compiler contracts ``dx*dx + dy*dy + dz*dz`` into
fused multiply-adds, which the port's build forbids (``-ffp-contract=off``)
so that the helper rounds as the plain version, and as the CUDA kernel
(built with ``-fmad=false``).  There the port's helper is held against the
plain version.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genpose_tpu import native as jnative
from genpose_tpu.data import dataset_utils as jdu
from genpose_tpu_torch import native
from genpose_tpu_torch.data import dataset_utils as tdu
from genpose_tpu_torch.ops.pointcloud import farthest_point_sample_ref

ROOT = Path(__file__).resolve().parent.parent
REAL_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def helpers_built():
    assert native.build().exists(), "the port's host C helper did not build"
    assert jnative.available(), "the JAX package's host C helper did not build"


def _roi(seed: int, size: int, valid_frac: float):
    rng = np.random.default_rng(seed)
    depth = (rng.integers(300, 1500, (size, size))
             * (rng.random((size, size)) < valid_frac)).astype(np.float32)
    mask = (rng.random((size, size)) > 0.3).astype(np.float32)
    coord = (tdu.get_2d_coord_np(size, size) + rng.integers(0, 300, (2, 1, 1))).astype(np.float32)
    return depth, mask, coord


def _intrinsics():
    return REAL_K[0, 0], REAL_K[1, 1], REAL_K[0, 2], REAL_K[1, 2]


@pytest.mark.parametrize("scale", [1.0, 1e-3], ids=["scale_1", "scale_1e-3"])
def test_depth_mask_to_pcl(scale):
    depth, mask, coord = _roi(1, 96, 0.7)
    args = (depth, mask, coord[0], coord[1], *_intrinsics())
    got = native.depth_mask_to_pcl(*args, scale=scale)
    assert got.dtype == np.float32 and got.shape[1] == 3 and 0 < got.shape[0] < depth.size
    assert np.array_equal(got, jnative.depth_mask_to_pcl(*args, scale=scale))
    assert np.array_equal(got, tdu.depth_mask_to_pcl_ref(*args, scale=scale))


@pytest.mark.parametrize("n, n_pts", [(300, 1024), (512, 512), (5000, 700), (0, 64), (7, 1)],
                         ids=["n<n_pts", "n==n_pts", "n>n_pts", "n==0", "one"])
def test_sample_points(n, n_pts):
    pcl = np.random.default_rng(n).random((n, 3)).astype(np.float32)
    for seed in (3, 2**40 + 17):
        got = native.sample_points(pcl, n_pts, seed)
        assert got.dtype == np.float32 and got.shape == (n_pts, 3)
        assert np.array_equal(got, jnative.sample_points(pcl, n_pts, seed))
        assert np.array_equal(got, tdu._native_sample(pcl, n_pts, seed))


def test_seed_edge_cases_through_the_helper():
    """The seeds of ``test_torch_dataset_utils.py``'s stream test (the ends
    of the uint64 range, the splitmix64 increment) through the C path."""
    pcl = np.arange(3 * 5000, dtype=np.float32).reshape(5000, 3)
    for seed in (0, 1, 2**63 - 2, 2**64 - 1, 0x9E3779B97F4A7C15):
        got = native.sample_points(pcl, 700, seed)
        assert np.array_equal(got, jnative.sample_points(pcl, 700, seed)), seed
        assert np.array_equal(got, tdu._native_sample(pcl, 700, seed)), seed


@pytest.mark.parametrize("size, valid_frac, n_pts", [
    (64, 0.9, 1024),   # fewer valid points than n_pts: tiled
    (128, 0.9, 1024),  # more: the partial Fisher-Yates
    (32, 0.0, 64),     # no valid pixel: zeros
], ids=["tile", "sample", "all_invalid"])
def test_backproject_sample(size, valid_frac, n_pts):
    depth, mask, coord = _roi(size, size, valid_frac)
    for seed in (0, 12345):
        args = (depth, mask, coord[0], coord[1], *_intrinsics(), 1e-3, n_pts, seed)
        k, got = native.backproject_sample(*args)
        want_k, want = jnative.backproject_sample(*args)
        assert k == want_k and np.array_equal(got, want)
        assert got.dtype == np.float32 and got.shape == (n_pts, 3)
        if valid_frac == 0.0:
            assert k == 0 and not got.any()
    trng, rrng, jrng = (np.random.default_rng(7) for _ in range(3))
    for _ in range(3):
        got = tdu.backproject_and_sample(depth, REAL_K, coord, mask, n_pts, trng, scale=1e-3)
        ref = tdu.backproject_and_sample_ref(depth, REAL_K, coord, mask, n_pts, rrng,
                                             scale=1e-3)
        want = jdu.backproject_and_sample(depth, REAL_K, coord, mask, n_pts, jrng, scale=1e-3)
        assert got[0] == ref[0] == want[0]
        assert np.array_equal(got[1], ref[1]) and np.array_equal(got[1], want[1])
    assert len({int(r.integers(0, 2**63 - 1)) for r in (trng, rrng, jrng)}) == 1


def _grid_clouds(seed: int, b: int, n: int, tile: int = 1) -> np.ndarray:
    """(b, n, 3) clouds of multiples of 1/64 in [-0.5, 0.5]: exact float32
    distances; with ``tile`` > 1 each cloud is n // tile points repeated."""
    pts = np.random.default_rng(seed).integers(-32, 33, (b, n // tile, 3)) / 64.0
    return np.tile(pts, (1, tile, 1)).astype(np.float32)


@pytest.mark.parametrize("cloud", ["grid", "grid_tiled", "float", "float_tiled"])
def test_fps(cloud):
    # the "float" batch is one on which a build that fuses the squared
    # distance into multiply-adds picks another point (cloud 1, pick 115)
    rng = np.random.default_rng(124 if cloud == "float" else 12)
    pts = {"grid": lambda: _grid_clouds(11, 4, 1024),
           "grid_tiled": lambda: _grid_clouds(11, 4, 1024, tile=8),
           "float": lambda: rng.random((4, 1024, 3)).astype(np.float32),
           "float_tiled": lambda: np.tile(rng.random((4, 128, 3)).astype(np.float32),
                                          (1, 8, 1))}[cloud]()
    want = farthest_point_sample_ref(torch.from_numpy(pts), 512).numpy()
    batch = native.fps(pts, 512)
    single = np.stack([native.fps(p, 512) for p in pts])
    assert batch.dtype == np.int32 and batch.shape == (4, 512)
    assert np.array_equal(batch, want) and np.array_equal(single, want)
    if cloud.startswith("grid"):
        assert np.array_equal(batch, jnative.fps(pts, 512))
        assert np.array_equal(single[0], jnative.fps(pts[0], 512))
    if cloud.endswith("tiled"):
        # a tie goes to the first copy: 128 distinct points, then index 0 again
        first = batch[:, :128]
        assert (first < 128).all() and all(len(np.unique(r)) == 128 for r in first)
        assert not batch[:, 128:].any()


@pytest.mark.parametrize("m", [1, 1500], ids=["m=1", "m>n"])
def test_fps_edges(m):
    """One pick (index 0 only) and more picks than points (index 0 again
    once every distance is 0, as ``torch.argmax`` keeps the first)."""
    pts = _grid_clouds(13, 2, 1024)
    want = farthest_point_sample_ref(torch.from_numpy(pts), m).numpy()
    assert np.array_equal(native.fps(pts, m), want)
    assert np.array_equal(native.fps(pts, m), jnative.fps(pts, m))


def test_no_native_gives_the_plain_stream(monkeypatch):
    """``GENPOSE_NO_NATIVE=1`` takes the plain version without touching the
    library, with the same arrays and the same generator state."""
    depth, mask, coord = _roi(5, 128, 0.8)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    want = [tdu.backproject_and_sample(depth, REAL_K, coord, mask, 256, a, 1e-3)
            for _ in range(3)]
    monkeypatch.setenv("GENPOSE_NO_NATIVE", "1")

    def refuse():
        raise AssertionError("the library was called under GENPOSE_NO_NATIVE")

    monkeypatch.setattr(native, "get_lib", refuse)
    got = [tdu.backproject_and_sample(depth, REAL_K, coord, mask, 256, b, 1e-3)
           for _ in range(3)]
    for (gk, g), (wk, w) in zip(got, want):
        assert gk == wk and np.array_equal(g, w)
    assert a.integers(0, 2**63 - 1) == b.integers(0, 2**63 - 1)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The helper built anew into an empty directory, its cached handle
    dropped before and after."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.get_lib.cache_clear()
    yield tmp_path
    native.get_lib.cache_clear()


@pytest.mark.parametrize("broken", ["missing_compiler", "compiler_error"])
def test_failed_build_raises_with_the_compilers_message(fresh_build, monkeypatch, broken):
    if broken == "missing_compiler":
        monkeypatch.setattr(native, "CXX", str(fresh_build / "no-such-g++"))
        expect = "no-such-g++"
    else:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-option",))
        expect = "-fno-such-option"  # g++ names the option it refuses
    with pytest.raises(RuntimeError, match="GENPOSE_NO_NATIVE") as err:
        native.get_lib()
    assert expect in str(err.value)
    assert not list(fresh_build.glob("*.so"))


_BUILD_INTO = ("import sys; from pathlib import Path; from genpose_tpu_torch import native; "
               "native.BUILD_DIR = Path(sys.argv[1]); print(native.get_lib()._name)")


def test_concurrent_first_builds_load_one_library(fresh_build):
    """Four processes build at once into an empty directory (as test
    workers and forked loader processes do on first use): each loads the
    one library, no temporary file is left, and the library works."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_INTO, str(fresh_build)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert {out.strip() for out, _ in outs} == {str(native.library_path())}
    assert [p.name for p in fresh_build.iterdir()] == [native.library_path().name]
    pts = _grid_clouds(3, 1, 256)[0]
    assert np.array_equal(native.fps(pts, 64), jnative.fps(pts, 64))
