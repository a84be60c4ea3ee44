"""The port's multi-radius ball query and SA geometry against the JAX package.

``ball_query_msg`` answers every radius of an MSG stage in one call (on the
card, one kernel launch).  On the CPU it runs the plain version, which must
equal the JAX oracle ``genpose_tpu/ops/pointcloud.py::ball_query_ref``
radius by radius, bit for bit.  ``sa_geometry`` / ``cls_msg_geometry`` now
call it once per stage and must still return the JAX package's indices and
grouped coordinates.  The kernel itself is held against the same plain
version on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.models import pointnet2 as jpn
from genpose_tpu.ops import pointcloud as jpc
from genpose_tpu_torch.models import pointnet2 as tpn
from genpose_tpu_torch.ops import pointcloud as tpc


def _cloud(B, N, seed):
    return (np.random.default_rng(seed).normal(size=(B, N, 3)) * 0.1).astype(np.float32)


def _check_against_jax(radii, nsamples, xyz, new_xyz):
    got = tpc.ball_query_msg(radii, nsamples, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    assert len(got) == len(radii)
    for r, s, g in zip(radii, nsamples, got):
        assert g.dtype == torch.int32 and g.shape == (xyz.shape[0], new_xyz.shape[1], s)
        want = np.asarray(jpc.ball_query_ref(r, s, jnp.asarray(xyz), jnp.asarray(new_xyz)))
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"r={r} S={s}")
    return got


@pytest.mark.parametrize("N,M,radii", [(1024, 512, (0.02, 0.04)), (512, 256, (0.04, 0.08)),
                                       (256, 128, (0.08, 0.16))])
def test_ball_query_msg_matches_jax_at_the_stage_shapes(N, M, radii):
    """The three MSG stages of the light encoder at B=2, centers by FPS."""
    xyz = _cloud(2, N, seed=N)
    centers = np.array(jpc.gather_points(
        jnp.asarray(xyz), jpc.farthest_point_sample_ref(jnp.asarray(xyz), M)))
    got = _check_against_jax(radii, (16, 32), xyz, centers)
    assert all((g >= 0).all() and (g < N).all() for g in got)


def test_ball_query_msg_boundary_empty_and_three_radii():
    """The r=0.1 boundary point (d^2 == f32(0.01): outside under the
    double-then-f32 square), r=0.5 with a point on the sphere, empty balls
    (far centers), and three radii including r=0 (every ball empty)."""
    f32 = np.float32
    edge = np.array([[[0.09998, 0.002, 0.0], [0.05, 0, 0], [0.5, 0, 0], [0.49, 0, 0]]],
                    np.float32)
    assert f32(f32(f32(0.09998) ** 2) + f32(f32(0.002) ** 2)) == f32(0.1 * 0.1)
    origin = np.zeros((1, 1, 3), np.float32)
    got = _check_against_jax((0.1, 0.5), (4, 4), edge, origin)
    np.testing.assert_array_equal(got[0][0, 0].numpy(), [1, 1, 1, 1])
    np.testing.assert_array_equal(got[1][0, 0].numpy(), [0, 1, 3, 0])

    xyz = _cloud(3, 257, seed=4)
    far = xyz[:, :40] + 5.0
    got = _check_against_jax((0.01, 0.3), (8, 16), xyz, far)
    assert not any(g.any() for g in got)

    centers = xyz[:, :77].copy()
    got = _check_against_jax((0.05, 0.3, 0.0), (4, 32, 2), xyz, centers)
    assert not got[2].any()


def test_ball_query_is_the_one_radius_case():
    xyz = torch.from_numpy(_cloud(2, 100, seed=5))
    centers = xyz[:, :9].contiguous()
    (want,) = tpc.ball_query_msg((0.3,), (16,), xyz, centers)
    assert torch.equal(tpc.ball_query(0.3, 16, xyz, centers), want)
    assert torch.equal(want, tpc.ball_query_ref(0.3, 16, xyz, centers))
    with pytest.raises(ValueError):
        tpc.ball_query_msg((0.1, 0.2), (4,), xyz, centers)
    with pytest.raises(ValueError):
        tpc.ball_query_msg((), (), xyz, centers)


def test_ball_query_msg_dispatcher_keeps_cpu_tensors_off_the_wrapper(monkeypatch):
    import genpose_tpu_torch.ops.ball_query_cuda as mod

    xyz = torch.from_numpy(_cloud(2, 64, seed=6))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mod.ball_query_cuda((0.05, 0.1), (4, 8), xyz, xyz)  # a wrapper never falls back

    def no_kernel(*args, **kwargs):
        raise AssertionError("the CUDA wrapper was called for a CPU tensor")

    monkeypatch.setattr(mod, "ball_query_cuda", no_kernel)
    launches = mod.launches
    got = tpc.ball_query_msg((0.05, 0.1), (4, 8), xyz, xyz[:, :16].contiguous())
    assert mod.launches == launches
    want = tpc.ball_query_msg_ref((0.05, 0.1), (4, 8), xyz, xyz[:, :16].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sa_geometry_matches_jax_index_for_index():
    """``cls_msg_geometry`` (one multi-radius ball query per stage) against
    the JAX package's on a seeded 1024-point cloud: FPS centers, ball-query
    indices exactly, grouped coordinates exactly (same float32 subtraction)."""
    pts = _cloud(2, 1024, seed=8)
    want = jpn.cls_msg_geometry(jnp.asarray(pts))
    got = tpn.cls_msg_geometry(torch.from_numpy(pts))
    assert len(got) == len(want) == 4
    for k, (g, w) in enumerate(zip(got, want)):
        if w["new_xyz"] is None:
            assert g["new_xyz"] is None and g["gidx"] == [None, None]
        else:
            np.testing.assert_array_equal(g["new_xyz"].numpy(), np.asarray(w["new_xyz"]))
            assert len(g["gidx"]) == len(w["gidx"]) == 2
            for a, b in zip(g["gidx"], w["gidx"]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"stage {k}")
        for a, b in zip(g["grouped_xyz"], w["grouped_xyz"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"stage {k}")


def test_sa_geometry_runs_one_ball_query_per_stage(monkeypatch):
    calls = []
    msg = tpn.ball_query_msg
    monkeypatch.setattr(tpn, "ball_query_msg",
                        lambda radii, *a: calls.append(tuple(radii)) or msg(radii, *a))
    tpn.cls_msg_geometry(torch.from_numpy(_cloud(1, 256, seed=9)))
    assert calls == [(0.02, 0.04), (0.04, 0.08), (0.08, 0.16)]
