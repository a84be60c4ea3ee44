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


@pytest.mark.parametrize("N,npoint", [(1024, 512), (512, 256), (256, 128), (777, 300),
                                      (64, 512), (5000, 64)])
def test_fps_kernel_equals_plain(dev, N, npoint):
    xyz = _cloud(dev, 4, N, seed=N)
    got = fps_mod.fps_cuda(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.farthest_point_sample_ref(xyz, npoint))


def test_fps_kernel_ties(dev):
    xyz = torch.zeros(3, 100, 3, device=dev)
    xyz[:, 50:] = 1.0
    assert torch.equal(fps_mod.fps_cuda(xyz, 150), pc.farthest_point_sample_ref(xyz, 150))


@pytest.mark.parametrize("N,M,radius,nsample", [
    (1024, 512, 0.02, 16), (1024, 512, 0.04, 32), (512, 256, 0.04, 16),
    (512, 256, 0.08, 32), (256, 128, 0.08, 16), (256, 128, 0.16, 32),
    (100, 9, 0.3, 16), (257, 40, 0.002, 4)])
def test_ball_query_kernel_equals_plain(dev, N, M, radius, nsample):
    xyz = _cloud(dev, 4, N, seed=M)
    centers = pc.gather_points(xyz, pc.farthest_point_sample_ref(xyz, M))
    got = bq_mod.ball_query_cuda(radius, nsample, xyz, centers)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.ball_query_ref(radius, nsample, xyz, centers))


@pytest.mark.parametrize("B,N,M,radii,nsamples", [
    (64, 1024, 512, (0.02, 0.04), (16, 32)), (64, 512, 256, (0.04, 0.08), (16, 32)),
    (64, 256, 128, (0.08, 0.16), (16, 32)), (4, 512, 256, (0.02, 0.04), (16, 32)),
    (3, 256, 128, (0.08, 0.16), (16, 32)), (2, 100, 64, (0.3,), (8,)),
    (3, 64, 512, (0.05, 1.0, 0.0), (4, 40, 2)), (2, 5000, 100, (0.01,), (7,))])
def test_fused_kernel_equals_plain(dev, B, N, M, radii, nsamples):
    """At the three stage shapes of the serving path (B=64), the JAX test's
    shapes, npoint > N with an empty-ball radius, and N > 4096."""
    xyz = _cloud(dev, B, N, seed=N + M)
    got_idx, got_bq = fused_mod.fps_bq_fused_cuda(xyz, M, radii, nsamples)
    torch.cuda.synchronize()
    want_idx, want_bq = pc.fps_bq_fused_ref(xyz, M, radii, nsamples)
    assert torch.equal(got_idx, want_idx)
    for got, want in zip(got_bq, want_bq):
        assert torch.equal(got, want)


def test_fused_kernel_exact_boundary(dev):
    """A point at d^2 == f32(0.01) from the first center: inside r=0.1
    when r^2 is rounded once from the double square, as the JAX package does."""
    xyz = torch.tensor([[[0.0, 0, 0], [0.09998, 0.002, 0.0], [0.05, 0, 0], [0.5, 0, 0],
                         [0.49, 0, 0]]], device=dev)
    got = fused_mod.fps_bq_fused_cuda(xyz, 3, (0.1, 0.5), (4, 4))
    want = pc.fps_bq_fused_ref(xyz, 3, (0.1, 0.5), (4, 4))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_dispatchers_launch_the_kernels(dev):
    xyz = _cloud(dev, 2, 128, seed=1)
    f0, b0, u0 = fps_mod.launches, bq_mod.launches, fused_mod.launches
    idx = pc.farthest_point_sample(xyz, 32)
    pc.ball_query(0.1, 8, xyz, pc.gather_points(xyz, idx))
    pc.fps_bq_fused(xyz, 32, (0.1,), (8,))
    assert (fps_mod.launches - f0, bq_mod.launches - b0, fused_mod.launches - u0) == (1, 1, 1)
