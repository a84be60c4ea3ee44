"""The port's training inputs and losses against the JAX package's, on the CPU:
pose errors, ranking, the DSM loss, augmentation, batch processing and
synthetic batches.  Inputs are numpy arrays given to both packages; random
draws are the JAX package's own, derived from its keys and handed to the
port.

Tolerances: integer and copied numpy code must be equal.  Float32 tensor
code agrees to a few ulps (rtol 1e-6, atol 1e-6 on metre-scale
coordinates), except where noted: angles from ``arccos`` (atol 1e-3
degrees: near cos = +-1 an ulp of the cosine is ~0.03 degrees, so the test
keeps angles away from 0 and 180), and the DSM loss (rtol 1e-5: a sum over
9 x bs x repeat terms of a score divided by sigma(t) down to 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import PtsAugConfig as JaxAug
from genpose_tpu.data import augment as jaug
from genpose_tpu.data.process import process_batch as jax_process_batch
from genpose_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from genpose_tpu.diffusion.losses import dsm_loss_repeated as jax_dsm_loss_repeated
from genpose_tpu.diffusion.sde import init_sde as jax_init_sde
from genpose_tpu.eval import metrics as jmetrics
from genpose_tpu.training import ranking as jranking
from genpose_tpu_torch.config import PtsAugConfig
from genpose_tpu_torch.data import augment as taug
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.diffusion.losses import dsm_loss, dsm_loss_repeated
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.eval import metrics as tmetrics
from genpose_tpu_torch.training import ranking as tranking
from _torch_parity import dsm_noise

SYNSETS = ("bottle", "bowl", "camera", "can", "laptop", "mug")
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# pose errors
# ---------------------------------------------------------------------------


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 9)).astype(np.float32), rng.normal(size=(n, 9)).astype(np.float32)


@pytest.mark.parametrize("o2c_pose", [True, False])
def test_pose_errors_match_jax(o2c_pose):
    """Every class, symmetric ones on the y-axis rule, mugs with and without
    a visible handle."""
    p1, p2 = _poses(24, seed=1)
    ids = np.tile(np.arange(6), 4).astype(np.int32)
    hv = np.repeat([1, 0], 12).astype(np.int32)
    want = jmetrics.pose_errors_jax(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ids),
                                    jnp.asarray(hv), SYNSETS, "rot_matrix", o2c_pose)
    got = tmetrics.pose_errors(_t(p1), _t(p2), _t(ids), _t(hv), SYNSETS, "rot_matrix", o2c_pose)
    theta_w = np.asarray(want[0])
    assert ((theta_w > 1) & (theta_w < 179)).all()  # away from the arccos edges
    np.testing.assert_allclose(got[0].numpy(), theta_w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-4)
    sym_w, mug_w = jmetrics.symmetry_flags(SYNSETS)
    sym_t, mug_t = tmetrics.symmetry_flags(SYNSETS)
    assert (sym_w == sym_t).all() and (mug_w == mug_t).all()


def test_get_metrics_and_compute_RT_errors_match_jax():
    p1, p2 = _poses(6, seed=2)
    ids, hv = np.arange(6), np.array([1, 1, 1, 1, 1, 0])
    want = jmetrics.get_metrics(p1, p2, ids, SYNSETS, hv, "rot_matrix", True)
    got = tmetrics.get_metrics(p1, p2, ids, SYNSETS, hv, "rot_matrix", True)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-3)
    rng = np.random.default_rng(3)
    for cls, h in ((0, 1), (2, 1), (5, 0), (5, 1)):
        RTs = []
        for _ in range(2):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            RT = np.eye(4)
            RT[:3, :3] = q * np.sign(np.linalg.det(q)) * rng.uniform(0.5, 2.0)
            RT[:3, 3] = rng.normal(size=3)
            RTs.append(RT)
        np.testing.assert_array_equal(tmetrics.compute_RT_errors(*RTs, cls, h, SYNSETS),
                                      jmetrics.compute_RT_errors(*RTs, cls, h, SYNSETS))


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 2, 5])
def test_ranking_loss_and_sort_results_match_jax(K):
    rng = np.random.default_rng(K)
    energy = rng.normal(size=(3, K, 2)).astype(np.float32)
    metrics = rng.integers(0, 3, size=(3, K, 2)).astype(np.float32)  # ties: stable order
    want_sorted = np.asarray(jranking.sort_results(jnp.asarray(energy), jnp.asarray(metrics)))
    got_sorted = tranking.sort_results(_t(energy), _t(metrics))
    np.testing.assert_array_equal(got_sorted.numpy(), want_sorted)
    want = float(jranking.ranking_loss(jnp.asarray(want_sorted)))
    got = tranking.ranking_loss(got_sorted)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if K == 1:
        assert float(got) == 0.0


# ---------------------------------------------------------------------------
# DSM loss
# ---------------------------------------------------------------------------


def _score_fns():
    """The same smooth score function and teacher on both sides."""
    w = np.random.default_rng(4).normal(size=(9, 9)).astype(np.float32) * 0.3

    def jscore(x, t):
        return jnp.tanh(x @ jnp.asarray(w)) - x * t

    def tscore(x, t):
        return torch.tanh(x @ _t(w)) - x * t

    def jteach(x, t):
        return -x / (0.1 + t)

    def tteach(x, t):
        return -x / (0.1 + t)

    return (jscore, jteach), (tscore, tteach)


@pytest.mark.parametrize("teacher", [False, True])
def test_dsm_loss_repeated_matches_jax(teacher):
    """The JAX loss with its key, the port's with the draws that key makes."""
    (js, jt), (ts, tt) = _score_fns()
    gt = np.random.default_rng(5).normal(size=(4, 9)).astype(np.float32)
    jsde, tsde = jax_init_sde("ve"), init_sde("ve")
    key = jax.random.PRNGKey(6)
    want = float(jax_dsm_loss_repeated(js, key, jnp.asarray(gt), jsde, 3,
                                       teacher_score_fn=jt if teacher else None))
    got = dsm_loss_repeated(ts, _t(gt), tsde, 3, teacher_score_fn=tt if teacher else None,
                            noise=dsm_noise(key, jsde.eps, 3, 4))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    one = dsm_loss(ts, _t(gt), tsde, noise=tuple(x[0] for x in dsm_noise(key, jsde.eps, 3, 4)))
    assert one.shape == ()
    gen = torch.Generator().manual_seed(0)
    drawn = dsm_loss_repeated(ts, _t(gt), tsde, 3, generator=gen)
    assert torch.isfinite(drawn)


# ---------------------------------------------------------------------------
# augmentation and batch processing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(7)
    b = jax_synthetic_batch(rng, bs=6, n_pts=64, n_model=128)
    b["cat_id"] = np.array([0, 1, 2, 3, 4, 5], np.int32)  # every class, bowl and mug included
    return b


def test_synthetic_batch_matches_jax():
    want = jax_synthetic_batch(np.random.default_rng(8), bs=5, n_pts=100, n_model=200)
    got = synthetic_batch(np.random.default_rng(8), bs=5, n_pts=100, n_model=200)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_process_batch_without_augmentation_matches_jax(raw):
    """Exact where no float sum is taken; the cloud center (a mean over the
    points, summed in another order) and what subtracts it within TOL."""
    want = {k: np.asarray(v) for k, v in jax_process_batch(raw).items()}
    got = {k: v.numpy() for k, v in process_batch(raw, device="cpu").items()}
    assert set(got) == set(want)
    for k in ("pts", "pts_color", "id", "handle_visibility", "gt_pose"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("zero_mean_pts", "zero_mean_gt_pose", "pts_center"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    small = process_batch(raw, mini_batch_size=2, device="cpu")
    assert small["pts"].shape[0] == 2


def test_deterministic_augmentations_match_jax(raw):
    b = {k: jnp.asarray(v) for k, v in raw.items()}
    t = {k: _t(v) for k, v in raw.items()}
    s = b["fsnet_scale"] + b["mean_shape"]
    want = jaug.defor_3D_bb_in_batch(b["pcl_in"], b["model_point"], b["rotation"],
                                     b["translation"], s, b["sym_info"], b["aug_bb"])
    got = taug.defor_3D_bb_in_batch(t["pcl_in"], t["model_point"], t["rotation"],
                                    t["translation"], t["fsnet_scale"] + t["mean_shape"],
                                    t["sym_info"], t["aug_bb"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want = jaug.defor_3D_rt_in_batch(b["pcl_in"], b["rotation"], b["translation"],
                                     b["aug_rt_t"], b["aug_rt_R"])
    got = taug.defor_3D_rt_in_batch(t["pcl_in"], t["rotation"], t["translation"],
                                    t["aug_rt_t"], t["aug_rt_R"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the box cage and the jitter with the JAX package's own draws
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    ey_up = jax.random.uniform(k1, (6, 1), minval=0.8, maxval=1.2)
    ey_down = jax.random.uniform(k2, (6, 1), minval=0.8, maxval=1.2)
    want = jaug.defor_3D_bc_in_batch(key, b["pcl_in"], b["rotation"], b["translation"], s,
                                     b["model_point"], b["nocs_scale"])
    got = taug.defor_3D_bc_in_batch(t["pcl_in"], t["rotation"], t["translation"],
                                    t["fsnet_scale"] + t["mean_shape"], t["model_point"],
                                    t["nocs_scale"], _t(ey_up), _t(ey_down))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    jitter = jax.random.uniform(key, b["pcl_in"].shape)
    want = jaug.defor_3D_pc(key, b["pcl_in"], b["translation"], 0.2)
    got = taug.defor_3D_pc(t["pcl_in"], t["translation"], 0.2, _t(jitter))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_draws(key, bs, n):
    """The draws ``data_augment`` makes from ``key``, as ``augment_draws`` lays them out."""
    k_bb, k_rt, k_bc, k_bc_p, k_pc, k_pc_p = jax.random.split(key, 6)
    k1, k2 = jax.random.split(k_bc)
    u = lambda k, shape=(bs, 1): _t(jax.random.uniform(k, shape))  # noqa: E731
    return {"bb": u(k_bb), "rt": u(k_rt), "bc": u(k_bc_p), "pc": u(k_pc_p),
            "ey_up": _t(jax.random.uniform(k1, (bs, 1), minval=0.8, maxval=1.2)),
            "ey_down": _t(jax.random.uniform(k2, (bs, 1), minval=0.8, maxval=1.2)),
            "jitter": u(k_pc, (bs, n, 3))}


def test_augmented_process_batch_matches_jax(raw):
    """Every flag set (probabilities 1), then the default probabilities,
    with the JAX package's draws."""
    for probs in (dict(aug_pc_pro=1.0, aug_rt_pro=1.0, aug_bb_pro=1.0, aug_bc_pro=1.0), {}):
        key = jax.random.PRNGKey(10)
        want = jax_process_batch(raw, "rot_matrix", key, JaxAug(**probs))
        got = process_batch(raw, "rot_matrix", pts_aug_params=PtsAugConfig(**probs),
                            device="cpu", draws=_jax_draws(key, 6, 64))
        for k in ("pts", "gt_pose", "zero_mean_pts", "zero_mean_gt_pose", "pts_center"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=2e-6, err_msg=f"{probs} {k}")
    gen = torch.Generator().manual_seed(0)
    drawn = process_batch(raw, pts_aug_params=PtsAugConfig(), generator=gen, device="cpu")
    assert torch.isfinite(drawn["zero_mean_pts"]).all()
