"""The port's fused FPS + ball query against the JAX package's, on the CPU.

``fps_bq_fused_ref`` (the plain version beside the CUDA kernel) must equal
the JAX ``fps_bq_fused`` bit for bit: indices are integers and both sides
compare the same float32 distances, computed in the same order, against the
same float32 r^2.  The JAX kernel runs in Pallas interpret mode here, as
``tests/test_pointcloud.py::test_fps_bq_fused_matches_components`` runs it.
The shapes are that test's: 512 -> 256 points with the stage-0 radii,
the stage-2 shape 256 -> 128 with its radii, and an unaligned N with one
radius.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.ops.fps_bq_fused import fps_bq_fused as jax_fps_bq_fused
from genpose_tpu_torch.ops import pointcloud as pc
from genpose_tpu_torch.tools import bench_fused_geometry as bench


@pytest.mark.parametrize("B,N,M,radii,nsamples", [
    (4, 512, 256, (0.02, 0.04), (16, 32)),
    (3, 256, 128, (0.08, 0.16), (16, 32)),
    (2, 100, 64, (0.3,), (8,)),
])
def test_fps_bq_fused_ref_equals_jax(B, N, M, radii, nsamples):
    pts = (np.random.RandomState(11).randn(B, N, 3) * 0.1).astype(np.float32)
    want_idx, want_bq = jax_fps_bq_fused(jnp.asarray(pts), M, radii, nsamples)
    got_idx, got_bq = pc.fps_bq_fused_ref(torch.from_numpy(pts), M, radii, nsamples)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert len(got_bq) == len(radii)
    for r, s, got, want in zip(radii, nsamples, got_bq, want_bq):
        assert got.dtype == torch.int32 and got.shape == (B, M, s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"r={r} S={s}")


def test_fps_bq_fused_ref_edge_cases():
    """npoint > N (index 0 repeats), first-hit padding, every point in the
    ball, and empty balls (a center is a point of the cloud, so only r=0,
    where d^2 < r^2 never holds, leaves a ball empty: all-zero rows)."""
    pts = torch.from_numpy((np.random.RandomState(3).randn(2, 40, 3) * 0.1).astype(np.float32))
    idx, (tiny, big, empty) = pc.fps_bq_fused_ref(pts, 60, (1e-4, 10.0, 0.0), (4, 8, 3))
    assert torch.equal(idx, pc.farthest_point_sample_ref(pts, 60))
    assert (idx[:, 40:] == 0).all()
    assert torch.equal(tiny, idx[..., None].expand(2, 60, 4))  # each center finds itself only
    assert torch.equal(big, torch.arange(8, dtype=torch.int32).expand(2, 60, 8))
    assert not empty.any()
    with pytest.raises(ValueError):
        pc.fps_bq_fused_ref(pts, 8, (0.1, 0.2), (4,))


def test_dispatcher_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    import genpose_tpu_torch.ops.fps_bq_fused_cuda as mod

    wrapper = mod.fps_bq_fused_cuda
    pts = torch.from_numpy((np.random.RandomState(5).randn(2, 64, 3) * 0.1).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(pts, 16, (0.05,), (4,))  # a wrapper never falls back

    def no_kernel(*args, **kwargs):
        raise AssertionError("the CUDA wrapper was called for a CPU tensor")

    monkeypatch.setattr(mod, "fps_bq_fused_cuda", no_kernel)
    launches = mod.launches
    got = pc.fps_bq_fused(pts, 16, (0.05, 0.1), (4, 8))
    want = pc.fps_bq_fused_ref(pts, 16, (0.05, 0.1), (4, 8))
    assert mod.launches == launches
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_chain_arms_agree_on_the_cpu():
    """Both arms of the A/B chain give the same indices at every stage (B=2;
    the plain versions run, so this holds the two compositions equal)."""
    pts = torch.from_numpy((np.random.RandomState(7).randn(2, 1024, 3) * 0.1).astype(np.float32))
    sep, fused = bench.chain(pts, use_fused=False), bench.chain(pts, use_fused=True)
    assert len(sep) == len(fused) == len(bench.STAGES)
    for (tag, _, M, radii, nsamples), (fi_s, bq_s), (fi_f, bq_f) in zip(bench.STAGES, sep, fused):
        assert fi_s.shape == (2, M)
        assert torch.equal(fi_s, fi_f), tag
        for s, a, b in zip(nsamples, bq_s, bq_f):
            assert a.shape == b.shape == (2, M, s)
            assert torch.equal(a, b), tag
    with pytest.raises(ValueError, match="CUDA tensor"):
        bench.measure(pts, iters=1)
