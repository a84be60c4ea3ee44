"""genpose_tpu_torch pose math and VE SDE against the JAX package.

Tolerance: 1e-6 absolute on unit-scale rotation quantities (float32
elementwise math with the same operation order; the transcendental and
norm routines of the two libraries differ by an ulp or so).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.diffusion.sde import init_sde as jax_init_sde
from genpose_tpu.ops import pose as jp
from genpose_tpu_torch.diffusion import samplers as tsamplers
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.ops import pose as tp
from _torch_parity import t_np

TOL = dict(rtol=1e-5, atol=1e-6)


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    qs = [np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)]
    return np.stack([q * np.sign(np.linalg.det(q)) for q in qs]).astype(np.float32)


@pytest.mark.parametrize("mode", ["quat_wxyz", "quat_xyzw", "euler_xyz",
                                  "euler_xyz_sx_cx", "rot_matrix"])
def test_get_pose_dim(mode):
    assert tp.get_pose_dim(mode) == jp.get_pose_dim(mode)


def test_quaternion_matrix_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(tp.quat_wxyz_to_matrix(t_np(q)).numpy(),
                               np.asarray(jp.quat_wxyz_to_matrix(jnp.asarray(q))), **TOL)
    m = _rotations(16, 1)
    np.testing.assert_allclose(tp.matrix_to_quat_wxyz(t_np(m)).numpy(),
                               np.asarray(jp.matrix_to_quat_wxyz(jnp.asarray(m))), **TOL)


def test_matrix_to_quat_non_orthonormal_matches_jax():
    """Scaled rotations (s*R, as NOCS pooling feeds them) are not normalised."""
    m = _rotations(8, 2) * np.linspace(0.3, 2.0, 8, dtype=np.float32)[:, None, None]
    np.testing.assert_allclose(tp.matrix_to_quat_wxyz(t_np(m)).numpy(),
                               np.asarray(jp.matrix_to_quat_wxyz(jnp.asarray(m))), **TOL)


def test_rot6d_transposed_convention_matches_jax():
    rng = np.random.default_rng(3)
    d6 = rng.normal(size=(16, 6)).astype(np.float32)
    got = tp.rot6d_to_matrix(t_np(d6)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.rot6d_to_matrix(jnp.asarray(d6))), **TOL)
    # the 6D vector holds the first two COLUMNS
    m = _rotations(4, 4)
    np.testing.assert_array_equal(tp.matrix_to_rot6d(t_np(m)).numpy()[:, :3], m[:, :, 0])
    for mode in ("rot_matrix", "quat_wxyz"):
        x = rng.normal(size=(8, 6 if mode == "rot_matrix" else 4)).astype(np.float32)
        np.testing.assert_allclose(
            tp.normalize_rotation(t_np(x), mode).numpy(),
            np.asarray(jp.normalize_rotation(jnp.asarray(x), mode)), **TOL)
        np.testing.assert_allclose(
            tp.get_rot_matrix(t_np(x), mode).numpy(),
            np.asarray(jp.get_rot_matrix(jnp.asarray(x), mode)), **TOL)


def test_average_quaternion_batch_matches_jax_up_to_sign():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, 6, 4)).astype(np.float32)
    q[..., 0] += 2.0  # a clear mean direction
    w = rng.uniform(0.1, 1.0, size=(4, 6)).astype(np.float32)
    for weights in (None, w):
        got = tp.average_quaternion_batch(
            t_np(q), None if weights is None else t_np(weights)).numpy()
        want = np.asarray(jp.average_quaternion_batch(
            jnp.asarray(q), None if weights is None else jnp.asarray(weights)))
        sign = np.sign(np.sum(got * want, axis=1, keepdims=True))
        np.testing.assert_allclose(got * sign, want, atol=1e-5)
        assert (got[:, 0] >= 0).all()


def test_ve_sde_matches_jax():
    jsde, tsde = jax_init_sde("ve"), init_sde("ve")
    assert (tsde.eps, tsde.T) == (jsde.eps, jsde.T)
    t = np.array([1e-5, 0.1, 0.55, 1.0], np.float32)
    np.testing.assert_allclose(tsde.marginal_prob(None, t_np(t))[1].numpy(),
                               np.asarray(jsde.marginal_prob(None, jnp.asarray(t))[1]),
                               rtol=1e-6)
    for got, want in zip(tsde.sde(t_np(t)), jsde.sde(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want) * np.ones_like(t), rtol=1e-6)
    z = np.random.default_rng(6).normal(size=(5, 9)).astype(np.float32)
    sigma_t = float(jsde.marginal_prob(None, 0.55)[1])
    np.testing.assert_allclose(tsde.prior((5, 9), T=0.55, noise=t_np(z)).numpy(),
                               z * np.float32(sigma_t), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert tsde.prior((5, 9), T=1.0, generator=g).shape == (5, 9)


@pytest.mark.parametrize("mode", ["vp", "subvp", "edm", "nope"])
def test_other_sdes_are_not_ported(mode):
    """Every SDE of the JAX package is ported now (its schedules are held
    against JAX in ``test_torch_sde_samplers.py``): each builds with the
    JAX eps and T, and only an unknown mode raises."""
    if mode == "nope":
        with pytest.raises(NotImplementedError):
            init_sde(mode)
        return
    from genpose_tpu.diffusion.sde import init_sde as jax_init_sde

    sde, want = init_sde(mode), jax_init_sde(mode)
    assert (sde.mode, sde.eps, sde.T) == (want.mode, want.eps, want.T)


@pytest.mark.parametrize("num", [2, 5, 500])
def test_linspace_matches_jnp_linspace(num):
    """The Heun time grid: same formula as jnp.linspace, whose float32 sum XLA
    rounds its own way; every value agrees to 2 ulps of the start (0.55)."""
    got = tsamplers._linspace(0.55, 1e-5, num, "cpu").numpy()
    want = np.asarray(jnp.linspace(0.55, 1e-5, num))
    assert got[0] == want[0] and got[-1] == want[-1]
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(0.55)))
