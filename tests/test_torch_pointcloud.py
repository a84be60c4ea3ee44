"""genpose_tpu_torch point-cloud ops against the JAX package.

The port's plain FPS and ball query (``genpose_tpu_torch/ops/pointcloud.py``)
must equal, bit for bit, both the JAX oracles (``genpose_tpu/ops/
pointcloud.py``) and the Pallas kernels they replace, run here in interpret
mode as ``tests/test_pointcloud.py`` runs them.  The CUDA kernels themselves
are held against the same plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.ops import pointcloud as jpc
from genpose_tpu.ops.ball_query_pallas import ball_query_pallas
from genpose_tpu.ops.fps_pallas import fps_pallas
from genpose_tpu_torch.ops import pointcloud as tpc


def _cloud(kind, B, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "dup":  # few distinct points, each repeated: argmax ties everywhere
        base = rng.normal(size=(B, max(N // 10, 1), 3)).astype(np.float32) * 0.1
        return np.repeat(base, 10, axis=1)[:, :N]
    return (rng.normal(size=(B, N, 3)) * 0.1).astype(np.float32)


FPS_CASES = {
    "random": ("normal", 3, 256, 64),
    "unaligned_n": ("normal", 2, 777, 32),
    "duplicate_points": ("dup", 2, 100, 40),
    "npoint_gt_n": ("normal", 2, 64, 512),  # light stage 0 on a small cloud
    "stage0_1024_to_512": ("normal", 1, 1024, 512),
}


@pytest.mark.parametrize("case", list(FPS_CASES))
def test_fps_plain_matches_jax_oracle_and_pallas(case):
    kind, B, N, npoint = FPS_CASES[case]
    xyz = _cloud(kind, B, N, seed=len(case))
    got = tpc.farthest_point_sample_ref(torch.from_numpy(xyz), npoint).numpy()
    assert got.dtype == np.int32 and got.shape == (B, npoint)
    oracle = np.asarray(jpc.farthest_point_sample_ref(jnp.asarray(xyz), npoint))
    pallas = np.asarray(fps_pallas(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


BQ_CASES = {
    # (kind, B, N, M, radius, nsample)
    "random": ("normal", 2, 128, 16, 0.1, 8),
    "unaligned": ("normal", 1, 100, 9, 0.3, 16),
    "mostly_empty": ("normal", 3, 257, 40, 0.002, 4),
    "duplicate_points": ("dup", 2, 120, 24, 0.05, 32),
    "stage0_r02": ("normal", 1, 1024, 512, 0.02, 16),
    "stage0_r04": ("normal", 1, 1024, 512, 0.04, 32),
}


@pytest.mark.parametrize("case", list(BQ_CASES))
def test_ball_query_plain_matches_jax_oracle_and_pallas(case):
    kind, B, N, M, radius, nsample = BQ_CASES[case]
    xyz = _cloud(kind, B, N, seed=len(case))
    rng = np.random.default_rng(7)
    new_xyz = xyz[:, :M] + rng.normal(size=(B, M, 3)).astype(np.float32) * 0.01
    if case == "mostly_empty":
        new_xyz[:, ::2] += 5.0  # far away: these balls hold nothing
    got = tpc.ball_query_ref(radius, nsample, torch.from_numpy(xyz),
                             torch.from_numpy(new_xyz)).numpy()
    assert got.dtype == np.int32 and got.shape == (B, M, nsample)
    oracle = np.asarray(jpc.ball_query_ref(radius, nsample, jnp.asarray(xyz),
                                           jnp.asarray(new_xyz)))
    pallas = np.asarray(ball_query_pallas(radius, nsample, jnp.asarray(xyz),
                                          jnp.asarray(new_xyz)))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    if case == "mostly_empty":
        assert (got[:, ::2] == 0).all()


def test_ball_query_exact_boundary():
    """A point with d^2 == r^2 in float32 is outside (strict <), and r^2 is
    the double-precision square rounded once: for r=0.1 a float32 square of
    float32(0.1) lands one ulp higher and would let the boundary point in."""
    f32 = np.float32
    r = 0.1
    on = np.array([f32(0.09998), f32(0.002), f32(0.0)], np.float32)
    d2 = f32(f32(on[0] * on[0]) + f32(on[1] * on[1]))
    assert d2 == f32(r * r) < f32(f32(r) * f32(r))  # the premise of the case
    inside = np.array([0.05, 0.0, 0.0], np.float32)
    # r=0.5: r^2 = 0.25 exactly and (0.5, 0, 0) sits on the sphere
    xyz = np.stack([on, inside, np.array([0.5, 0, 0], np.float32),
                    np.array([0.49, 0, 0], np.float32)])[None]
    center = np.zeros((1, 1, 3), np.float32)
    for radius, want in ((r, [1, 1, 1, 1]), (0.5, [0, 1, 3, 0])):
        got = tpc.ball_query_ref(radius, 4, torch.from_numpy(xyz),
                                 torch.from_numpy(center)).numpy()
        oracle = np.asarray(jpc.ball_query_ref(radius, 4, jnp.asarray(xyz),
                                               jnp.asarray(center)))
        pallas = np.asarray(ball_query_pallas(radius, 4, jnp.asarray(xyz),
                                              jnp.asarray(center)))
        np.testing.assert_array_equal(got[0, 0], want)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, pallas)


def test_radius_is_squared_in_double():
    assert tpc.radius_sq_f32(0.1) == float(np.float32(0.1 * 0.1))
    assert tpc.radius_sq_f32(0.1) != float(np.float32(np.float32(0.1) * np.float32(0.1)))


def test_dispatchers_use_plain_versions_on_cpu():
    xyz = torch.from_numpy(_cloud("normal", 2, 96, seed=3))
    idx = tpc.farthest_point_sample(xyz, 16)
    assert torch.equal(idx, tpc.farthest_point_sample_ref(xyz, 16))
    centers = tpc.gather_points(xyz, idx)
    assert torch.equal(tpc.ball_query(0.08, 16, xyz, centers),
                       tpc.ball_query_ref(0.08, 16, xyz, centers))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no quiet plain fallback."""
    from genpose_tpu_torch.ops.ball_query_cuda import ball_query_cuda
    from genpose_tpu_torch.ops.fps_cuda import fps_cuda

    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError):
        fps_cuda(xyz, 4)
    with pytest.raises(ValueError):
        ball_query_cuda((0.1,), (4,), xyz, xyz)


def test_gather_and_group_match_jax():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 7, 4)).astype(np.int32)
    got = tpc.group_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    want = np.asarray(jpc.group_points(jnp.asarray(pts), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    got = tpc.gather_points(torch.from_numpy(pts), torch.from_numpy(idx[:, :, 0])).numpy()
    want = np.asarray(jpc.gather_points(jnp.asarray(pts), jnp.asarray(idx[:, :, 0])))
    np.testing.assert_array_equal(got, want)
