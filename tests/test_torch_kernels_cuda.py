"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and the CUDA toolkit, and skip
elsewhere.  On a machine with a card and no JAX, run them without the
repository's conftest (which configures JAX):
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.  Whether
a card is present is decided inside the fixture, never at import.
"""

import pytest
import torch

from genpose_tpu_torch.ops import ball_query_cuda as bq_mod
from genpose_tpu_torch.ops import fps_bq_fused_cuda as fused_mod
from genpose_tpu_torch.ops import fps_cuda as fps_mod
from genpose_tpu_torch.ops import pointcloud as pc

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _cloud(dev, B, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, N, 3, device=dev, generator=g) * 0.1


@pytest.mark.parametrize("B,N,npoint", [
    (4, 1024, 512), (4, 512, 256), (4, 256, 128), (192, 1024, 512), (4, 777, 300),
    (4, 64, 512), (4, 5000, 64), (3, 1, 8), (3, 31, 40), (3, 33, 40), (2, 8192, 64)])
def test_fps_kernel_equals_plain(dev, B, N, npoint):
    """The path shapes (B=4, and B=192 as in training), and N = 1, 31, 33,
    8192, which cross each threads-per-cloud choice and its padding."""
    xyz = _cloud(dev, B, N, seed=N)
    got = fps_mod.fps_cuda(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.farthest_point_sample_ref(xyz, npoint))


@pytest.mark.parametrize("N", [32, 64, 65, 128, 129, 256, 257, 512, 513, 1024])
def test_fps_kernel_every_points_per_thread(dev, N):
    """Each edge of the kernel's choice of points per thread (one warp with
    1, 2, 4, 8 or 16 up to N = 512, then 8 on several warps), with npoint
    past N so that the padding meets the tie rule."""
    xyz = _cloud(dev, 3, N, seed=N + 1)
    got = fps_mod.fps_cuda(xyz, N + 20)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.farthest_point_sample_ref(xyz, N + 20))


def test_fps_kernel_ties(dev):
    xyz = torch.zeros(3, 100, 3, device=dev)
    xyz[:, 50:] = 1.0
    assert torch.equal(fps_mod.fps_cuda(xyz, 150), pc.farthest_point_sample_ref(xyz, 150))


@pytest.mark.parametrize("N,M,radius,nsample", [
    (1024, 512, 0.02, 16), (1024, 512, 0.04, 32), (512, 256, 0.04, 16),
    (512, 256, 0.08, 32), (256, 128, 0.08, 16), (256, 128, 0.16, 32),
    (100, 9, 0.3, 16), (257, 40, 0.002, 4)])
def test_ball_query_kernel_equals_plain(dev, N, M, radius, nsample):
    """One radius (R = 1) at each stage's radii and at odd shapes."""
    xyz = _cloud(dev, 4, N, seed=M)
    centers = pc.gather_points(xyz, pc.farthest_point_sample_ref(xyz, M))
    (got,) = bq_mod.ball_query_cuda((radius,), (nsample,), xyz, centers)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.ball_query_ref(radius, nsample, xyz, centers))


@pytest.mark.parametrize("B,N,M,radii,nsamples", [
    (64, 1024, 512, (0.02, 0.04), (16, 32)), (64, 512, 256, (0.04, 0.08), (16, 32)),
    (64, 256, 128, (0.08, 0.16), (16, 32)), (192, 1024, 512, (0.02, 0.04), (16, 32)),
    (4, 777, 77, (0.3,), (32,)), (4, 512, 100, (0.05, 0.3, 0.0), (4, 32, 2)),
    (2, 4096, 300, (0.01, 0.05), (7, 40)), (3, 64, 20, (0.1, 0.2, 0.3, 1.0), (0, 5, 9, 64))])
def test_ball_query_msg_kernel_equals_plain(dev, B, N, M, radii, nsamples):
    """Every radius of a stage in one launch: the three stage shapes (B=64
    and B=192), R = 1, R = 3 with r = 0 (every ball empty), N = 4096, and
    R = 4 with an empty row (S = 0)."""
    xyz = _cloud(dev, B, N, seed=N + M)
    centers = pc.gather_points(xyz, pc.farthest_point_sample_ref(xyz, M))
    launches = bq_mod.launches
    got = bq_mod.ball_query_cuda(radii, nsamples, xyz, centers)
    torch.cuda.synchronize()
    assert bq_mod.launches == launches + 1
    for g, w in zip(got, pc.ball_query_msg_ref(radii, nsamples, xyz, centers)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B", [98, 99])
def test_ball_query_msg_kernel_every_lanes_per_center(dev, B):
    """Both of the kernel's choices of lanes per center, on either side of
    B * M = 32768 (8 lanes below, 1 from there on), with a center count
    that leaves a block part-empty."""
    xyz = _cloud(dev, B, 1024, seed=B)
    centers = pc.gather_points(xyz, pc.farthest_point_sample_ref(xyz, 333))
    got = bq_mod.ball_query_cuda((0.02, 0.04), (16, 32), xyz, centers)
    torch.cuda.synchronize()
    for g, w in zip(got, pc.ball_query_msg_ref((0.02, 0.04), (16, 32), xyz, centers)):
        assert torch.equal(g, w)


def test_ball_query_msg_kernel_boundary_and_empty_balls(dev):
    """The r=0.1 and r=0.5 boundary points, and balls far from every point."""
    edge = torch.tensor([[[0.09998, 0.002, 0.0], [0.05, 0, 0], [0.5, 0, 0], [0.49, 0, 0]]],
                        device=dev)
    origin = torch.zeros(1, 1, 3, device=dev)
    got = bq_mod.ball_query_cuda((0.1, 0.5), (4, 4), edge, origin)
    assert [g[0, 0].tolist() for g in got] == [[1, 1, 1, 1], [0, 1, 3, 0]]
    xyz = _cloud(dev, 5, 777, seed=3)
    got = bq_mod.ball_query_cuda((0.01, 0.1), (8, 16), xyz, xyz[:, :40] + 5.0)
    assert not any(g.any() for g in got)


def _fused_both_ways(xyz, M, radii, nsamples):
    """The fused kernel against its plain version and, up to the ball-query
    kernel's 4096 points, against the separate kernels (FPS, gather, ball
    query in launches of at most 4 radii)."""
    launches = fused_mod.launches
    got_idx, got_bq = fused_mod.fps_bq_fused_cuda(xyz, M, radii, nsamples)
    torch.cuda.synchronize()
    assert fused_mod.launches == launches + 1
    want_idx, want_bq = pc.fps_bq_fused_ref(xyz, M, radii, nsamples)
    assert torch.equal(got_idx, want_idx)
    assert len(got_bq) == len(want_bq) == len(radii)
    for got, want in zip(got_bq, want_bq):
        assert got.shape == (xyz.shape[0], M, want.shape[-1])
        assert torch.equal(got, want)
    sep_idx = fps_mod.fps_cuda(xyz, M)
    assert torch.equal(got_idx, sep_idx)
    if xyz.shape[1] <= bq_mod.MAX_POINTS:
        centers = pc.gather_points(xyz, sep_idx)
        sep_bq = sum((bq_mod.ball_query_cuda(radii[k:k + 4], nsamples[k:k + 4], xyz, centers)
                      for k in range(0, len(radii), 4)), ())
        torch.cuda.synchronize()
        assert all(torch.equal(got, sep) for got, sep in zip(got_bq, sep_bq))


R3 = ((0.05, 0.3, 0.0), (4, 40, 2))  # with r = 0: every ball empty
R8 = ((0.01, 0.02, 0.04, 0.08, 0.16, 0.3, 0.0, 1.0), (3, 16, 32, 5, 33, 64, 2, 7))
R8B = ((0.08, 0.16, 0.02, 0.04, 0.3, 0.5, 0.0, 0.1), (16, 32, 1, 2, 3, 4, 5, 6))


@pytest.mark.parametrize("B,N,M,radii,nsamples", [
    # the three stage shapes of the serving path (B=64) and of training (B=192)
    (64, 1024, 512, (0.02, 0.04), (16, 32)), (64, 512, 256, (0.04, 0.08), (16, 32)),
    (64, 256, 128, (0.08, 0.16), (16, 32)), (192, 1024, 512, (0.02, 0.04), (16, 32)),
    (192, 512, 256, (0.04, 0.08), (16, 32)), (192, 256, 128, (0.08, 0.16), (16, 32)),
    # the JAX test's shapes
    (4, 512, 256, (0.02, 0.04), (16, 32)), (3, 256, 128, (0.08, 0.16), (16, 32)),
    (2, 100, 64, (0.3,), (8,)),
    # each edge of the producers' shape (one warp with P = 1..16 up to 512
    # points, P = 8 on several warps up to 4096, P = 16 up to 8192), with
    # npoint past N so that the padding meets the tie rule
    *[(3, n, n + 20, *R3) for n in (32, 64, 65, 256, 257, 512, 513, 1024, 4096, 4097, 8192)],
    (2, 5000, 100, (0.01,), (7,)),
    # R = 1, 5 and 8, which set the consumer warps (four per radius, fewer
    # where the block has no room, then taking several radii each) and the
    # ring (16 slots, 8 above 2048 points, 4 above 4096)
    (4, 1024, 512, (0.04,), (32,)), (4, 1024, 300, *R8), (3, 256, 128, *R8B),
    (2, 4096, 40, *R8), (2, 6000, 50, (0.01, 0.05, 0.1, 0.2, 0.3), (4, 8, 16, 32, 64)),
    (2, 8192, 40, *R8),
    # npoint = 1: only the last, FPS-free distance pass
    *[(3, n, 1, (0.05, 0.3), (4, 40)) for n in (1, 100, 1024, 4096, 8192)]])
def test_fused_kernel_equals_plain(dev, B, N, M, radii, nsamples):
    """Bit for bit against its plain version and the separate kernels."""
    _fused_both_ways(_cloud(dev, B, N, seed=N + M), M, radii, nsamples)


def test_fused_kernel_exact_boundary(dev):
    """A point at d^2 == f32(0.01) from the first center: inside r=0.1
    when r^2 is rounded once from the double square, as the JAX package does."""
    xyz = torch.tensor([[[0.0, 0, 0], [0.09998, 0.002, 0.0], [0.05, 0, 0], [0.5, 0, 0],
                         [0.49, 0, 0]]], device=dev)
    got = fused_mod.fps_bq_fused_cuda(xyz, 3, (0.1, 0.5), (4, 4))
    want = pc.fps_bq_fused_ref(xyz, 3, (0.1, 0.5), (4, 4))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_fused_kernel_refuses_more_than_8192_points(dev):
    launches = fused_mod.launches
    with pytest.raises(ValueError, match="1..8192 points"):
        fused_mod.fps_bq_fused_cuda(_cloud(dev, 1, 8193, seed=0), 8, (0.1,), (4,))
    assert fused_mod.launches == launches


def test_dispatchers_launch_the_kernels(dev):
    xyz = _cloud(dev, 2, 128, seed=1)
    f0, b0, u0 = fps_mod.launches, bq_mod.launches, fused_mod.launches
    idx = pc.farthest_point_sample(xyz, 32)
    pc.ball_query_msg((0.1, 0.2), (8, 16), xyz, pc.gather_points(xyz, idx))  # one launch
    pc.fps_bq_fused(xyz, 32, (0.1,), (8,))
    assert (fps_mod.launches - f0, bq_mod.launches - b0, fused_mod.launches - u0) == (1, 1, 1)
    pc.ball_query(0.1, 8, xyz, pc.gather_points(xyz, idx))
    assert bq_mod.launches - b0 == 2


@pytest.mark.parametrize("B", [64, 192])
@pytest.mark.parametrize("duplicates", [False, True], ids=["distinct", "tiled"])
@pytest.mark.parametrize("config", ["full", "lighter", "dense", "msg"])
def test_stage_chains_of_every_config_equal_plain(dev, config, duplicates, B):
    """The FPS and ball-query launches of each PointNet++ configuration's
    stage chain (``Pointnet2ClsMSG``'s ``full``, ``lighter``, ``dense`` and
    ``Pointnet2MSG``'s ``MSG_CFG``) at N = 1024, the serving batch (64) and
    the training batch (192): 1024 -> 512 -> 256 -> 128 (-> 64) centres,
    one launch per stage for all its radii (``lighter``'s first stage is
    r = 0.01 with nsample 64).  ``tiled`` clouds repeat 200 points, as
    ``sample_points`` tiles a small object, so distances tie exactly."""
    from genpose_tpu_torch.models.pointnet2 import CLS_MSG_CONFIGS, MSG_CFG

    cfg = MSG_CFG if config == "msg" else CLS_MSG_CONFIGS[config]
    xyz = _cloud(dev, B, 200 if duplicates else 1024, seed=B + len(config))
    if duplicates:
        xyz = xyz.repeat(1, 6, 1)[:, :1024].contiguous()
    stages = [k for k, m in enumerate(cfg["NPOINTS"]) if m is not None]
    f0, b0 = fps_mod.launches, bq_mod.launches
    for k in stages:
        idx = fps_mod.fps_cuda(xyz, cfg["NPOINTS"][k])
        assert torch.equal(idx, pc.farthest_point_sample_ref(xyz, cfg["NPOINTS"][k])), k
        centers = pc.gather_points(xyz, idx)
        radii, nsamples = cfg["RADIUS"][k], cfg["NSAMPLE"][k]
        got = bq_mod.ball_query_cuda(radii, nsamples, xyz, centers)
        for g, w in zip(got, pc.ball_query_msg_ref(radii, nsamples, xyz, centers)):
            assert torch.equal(g, w), (k, radii)
        xyz = centers
    torch.cuda.synchronize()
    assert (fps_mod.launches - f0, bq_mod.launches - b0) == (len(stages), len(stages))
