"""genpose_tpu_torch's encoders, per-point tails and Euler pose math against
the JAX package, on the CPU.

Weights: a JAX module's seeded init, every parameter perturbed (the zero
inits would hide a wrong mapping) and its BatchNorm statistics moved, then
``utils/weights.py::from_jax_variables``.  Inputs come from numpy seeds.
Tolerance: rtol = atol = 1e-5 in float32 (as ``test_torch_models.py``);
index tables (FPS, ball query, three-NN) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.diffusion.sde import init_sde as jax_init_sde
from genpose_tpu.models import pointnet as jpn
from genpose_tpu.models import pointnet2 as jpn2
from genpose_tpu.models.scorenet import PoseScoreNet as JaxScoreNet
from genpose_tpu.ops import pointcloud as jpc
from genpose_tpu.ops import pose as jpose
from genpose_tpu_torch.diffusion.samplers import _block_normalize
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.models import pointnet as tpn
from genpose_tpu_torch.models import pointnet2 as tpn2
from genpose_tpu_torch.models.scorenet import PoseScoreNet
from genpose_tpu_torch.ops import pointcloud as tpc
from genpose_tpu_torch.ops import pose as tpose
from genpose_tpu_torch.utils.weights import from_jax_variables, init_params_
from _torch_parity import t_np

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch CPU thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(variables, seed):
    """The variables with every parameter moved by N(0, 0.05^2) and the
    BatchNorm statistics moved off (0, 1)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.asarray(s) + 0.1 * rng.normal(size=s.shape) if "mean" in
                         jax.tree_util.keystr(path) else
                         np.asarray(s) * rng.uniform(0.5, 1.5, size=s.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    return params, stats


def _load(module, params, stats):
    module.load_state_dict(from_jax_variables(params, stats))
    return module.eval()


def _cloud(b, n, seed, scale=0.1):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Euler pose modes
# ---------------------------------------------------------------------------


def _angles(seed):
    """Random angles and gimbal-near ones (middle angle at +-pi/2, 0, pi)."""
    rng = np.random.default_rng(seed)
    rand = rng.uniform(-np.pi, np.pi, size=(16, 3))
    near = np.array([[0.3, np.pi / 2, -1.1], [2.0, -np.pi / 2, 0.4],
                     [-0.7, np.pi / 2 - 1e-4, 0.9], [1.3, -np.pi / 2 + 1e-6, -2.9],
                     [0.0, 0.0, 0.0], [np.pi, np.pi, -np.pi]])
    return np.concatenate([rand, near]).astype(np.float32)


@pytest.mark.parametrize("mode", ["euler_xyz", "euler_xyz_sx_cx"])
def test_euler_rotation_matches_jax(mode):
    ang = _angles(1)
    rot = ang if mode == "euler_xyz" else np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    rot = rot + (0.0 if mode == "euler_xyz" else
                 0.05 * np.random.default_rng(2).normal(size=rot.shape).astype(np.float32))
    np.testing.assert_allclose(tpose.euler_zyx_to_matrix(t_np(ang)).numpy(),
                               np.asarray(jpose.euler_zyx_to_matrix(jnp.asarray(ang))), **TOL)
    got = tpose.get_rot_matrix(t_np(rot), mode).numpy()
    np.testing.assert_allclose(got, np.asarray(jpose.get_rot_matrix(jnp.asarray(rot), mode)),
                               **TOL)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
    np.testing.assert_allclose(tpose.normalize_rotation(t_np(rot), mode).numpy(),
                               np.asarray(jpose.normalize_rotation(jnp.asarray(rot), mode)),
                               **TOL)
    pose = np.concatenate([rot, np.ones((len(rot), 3), np.float32)], axis=-1)
    R, t = tpose.pose_to_rt(t_np(pose), mode)
    np.testing.assert_array_equal(R.numpy(), got)
    assert t.shape == (len(rot), 3)


def test_pc_block_normalize_takes_every_mode():
    """PC's per-step normalisation (JAX ``samplers.py:318-326``): ``euler_xyz``
    passes through, ``euler_xyz_sx_cx`` takes the 6D branch."""
    x = np.random.default_rng(3).normal(size=(5, 9)).astype(np.float32)
    out = _block_normalize(t_np(x[:, :6]), "euler_xyz").numpy()
    np.testing.assert_array_equal(out, x[:, :6])
    out = _block_normalize(t_np(x), "euler_xyz_sx_cx").numpy()
    np.testing.assert_array_equal(out, _block_normalize(t_np(x), "rot_matrix").numpy())
    np.testing.assert_allclose(np.linalg.norm(out[:, :3], axis=1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# three-NN interpolation
# ---------------------------------------------------------------------------


def _tie_clouds():
    """Known points with exact duplicates (a small cloud tiled, as
    ``sample_points`` pads) and grid points at equal distances from the
    unknown ones."""
    rng = np.random.default_rng(4)
    small = (rng.normal(size=(2, 5, 3)) * 0.1).astype(np.float32)
    tiled = np.concatenate([small] * 4 + [small[:, :3]], axis=1)  # [2, 23, 3]
    grid = np.stack(np.meshgrid(*[np.arange(3, dtype=np.float32) * 0.25] * 3,
                                indexing="ij"), -1).reshape(1, 27, 3)
    known = np.concatenate([tiled, np.repeat(grid, 2, 0)], axis=1)
    unknown = np.concatenate([small, np.repeat(grid[:, :9] + 0.125, 2, 0),
                              np.repeat(grid[:, 5:9], 2, 0)], axis=1)
    return unknown, known


@pytest.mark.parametrize("case", ["ties", "random"])
def test_three_nn_matches_jax_on_ties(case):
    if case == "ties":
        unknown, known = _tie_clouds()
    else:
        unknown, known = _cloud(3, 200, 5), _cloud(3, 50, 6)
    want_d, want_i = (np.asarray(a) for a in jpc.three_nn(jnp.asarray(unknown),
                                                          jnp.asarray(known)))
    got_d, got_i = tpc.three_nn(t_np(unknown), t_np(known))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # XLA's CPU code may fuse the squares into FMAs: distances agree to an ulp
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    if case == "ties":  # the duplicates and the grid make equal distances
        assert (want_d[..., 0] == want_d[..., 1]).any() and (want_d == 0).any()
    feats = np.random.default_rng(7).normal(size=known.shape[:2] + (6,)).astype(np.float32)
    w = np.random.default_rng(8).uniform(size=want_i.shape).astype(np.float32)
    np.testing.assert_allclose(
        tpc.three_interpolate(t_np(feats), got_i, t_np(w)).numpy(),
        np.asarray(jpc.three_interpolate(jnp.asarray(feats), jnp.asarray(want_i),
                                         jnp.asarray(w))), **TOL)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feature_transform", [False, True])
def test_pointnetfeat_matches_jax(feature_transform):
    pts = _cloud(3, 128, 9)
    jmod = jpn.PointNetfeat(feature_transform=feature_transform)
    params, _ = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(pts)), 10)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(pts)))
    tmod = _load(tpn.PointNetfeat(feature_transform=feature_transform), params, {})
    with torch.no_grad():
        got = tmod(t_np(pts)).numpy()
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got, want, **TOL)


def test_pointnet_transformer_starts_at_the_identity():
    net = init_params_(tpn.PointNetfeat(feature_transform=True), seed=0)
    x = t_np(_cloud(2, 32, 11))
    with torch.no_grad():
        assert torch.equal(net.stn(x), torch.eye(3).expand(2, 3, 3))
        assert torch.equal(net.fstn(torch.relu(net.Dense_0(x))), torch.eye(64).expand(2, 64, 64))


def _geometry_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w["new_xyz"] is None:
            assert g["new_xyz"] is None
        else:
            np.testing.assert_array_equal(g["new_xyz"].numpy(), np.asarray(w["new_xyz"]))
        for gi, wi in zip(g["gidx"], w["gidx"]):
            if wi is None:
                assert gi is None
            else:
                assert gi.dtype == torch.int32
                np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        for gx, wx in zip(g["grouped_xyz"], w["grouped_xyz"]):
            np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))


@pytest.mark.parametrize("config", ["full", "lighter", "dense"])
def test_cls_msg_configs_match_jax(config):
    """Feature within 1e-5; every stage's FPS and per-radius ball-query
    tables bit for bit; the shared geometry gives the inline result bit for
    bit."""
    pts = _cloud(2, 256, 12)
    jmod = jpn2.Pointnet2ClsMSG(config=config)
    params, stats = _perturbed(jmod.init(jax.random.PRNGKey(1), jnp.asarray(pts)), 13)
    want = np.asarray(jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(pts)))
    tmod = _load(tpn2.Pointnet2ClsMSG(config=config), params, stats)
    geom = tpn2.cls_msg_geometry(t_np(pts), config)
    _geometry_equal(geom, jpn2.cls_msg_geometry(jnp.asarray(pts), config))
    assert len(geom) == len(tpn2.CLS_MSG_CONFIGS[config]["NPOINTS"])
    with torch.no_grad():
        got = tmod(t_np(pts))
        shared = tmod(t_np(pts), geometry=geom)
    assert got.shape == (2, 1024)
    assert torch.equal(got, shared)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pointnet2_msg_matches_jax():
    """The SA + FP encoder in eval mode: per-point features and logit.
    (Train-mode BatchNorm is not held to JAX at 1e-5: flax takes the batch
    variance as E[x^2] - E[x]^2, PyTorch in two passes, and on a channel
    whose mean is large beside its spread the flax form loses digits; one
    SharedMLP on inputs offset by 3 standard deviations already differs by
    6e-5.)"""
    pts = _cloud(2, 256, 14)
    jmod = jpn2.Pointnet2MSG()
    params, stats = _perturbed(jmod.init(jax.random.PRNGKey(2), jnp.asarray(pts)), 15)
    want_f, want_l = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(pts))
    tmod = _load(tpn2.Pointnet2MSG(), params, stats)
    with torch.no_grad():
        got_f, got_l = tmod(t_np(pts))
    assert got_f.shape == (2, 256, 64) and got_l.shape == (2, 256, 1)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_pointnet2_msg_dropout_draws_from_the_generator():
    """Train-mode dropout on the logit head: from the generator, and only
    when one is given."""
    net = init_params_(tpn2.Pointnet2MSG(), seed=3).train()
    pts = t_np(_cloud(2, 128, 16))
    with torch.no_grad():
        a = net(pts, generator=torch.Generator().manual_seed(0))[1]
        b = net(pts, generator=torch.Generator().manual_seed(0))[1]
        c = net(pts, generator=torch.Generator().manual_seed(1))[1]
        d = net(pts)[1]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


# ---------------------------------------------------------------------------
# per-point tails
# ---------------------------------------------------------------------------


def test_per_point_score_net_matches_jax():
    """``PoseScoreNet(per_point_feature=True)`` in eval mode: RotHead /
    TransHead tails over per-point features, with a per-row and a
    step-shared t (train-mode BatchNorm: see ``test_pointnet2_msg_matches_jax``)."""
    rng = np.random.default_rng(17)
    feat = rng.normal(size=(3, 24, 96)).astype(np.float32)
    pose = rng.normal(size=(3, 9)).astype(np.float32)
    t = rng.uniform(1e-3, 1.0, size=(3, 1)).astype(np.float32)
    jnet = JaxScoreNet(marginal_prob_fn=jax_init_sde("ve").marginal_prob,
                       per_point_feature=True, pts_feat_dim=96)
    params, stats = _perturbed(jnet.init(jax.random.PRNGKey(3), jnp.asarray(feat),
                                         jnp.asarray(pose), jnp.asarray(t)), 18)
    v = {"params": params, "batch_stats": stats}
    tnet = _load(PoseScoreNet(init_sde("ve").marginal_prob, per_point_feature=True,
                              pts_feat_dim=96), params, stats)
    for t_in in (t, np.full((1, 1), 0.3, np.float32)):
        want = jnet.apply(v, jnp.asarray(feat), jnp.asarray(pose), jnp.asarray(t_in))
        with torch.no_grad():
            got = tnet.score_from(tnet.precompute(t_np(feat)), t_np(pose), t_np(t_in))
        assert got.shape == (3, 9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_per_point_dropout_draws_from_the_generator():
    """Train mode: the tails' dropout draws from the generator, and only
    when one is given."""
    net = init_params_(PoseScoreNet(init_sde("ve").marginal_prob, per_point_feature=True,
                                    pts_feat_dim=32), seed=4).train()
    rng = np.random.default_rng(19)
    feat, pose = t_np(rng.normal(size=(4, 8, 32)).astype(np.float32)), t_np(
        rng.normal(size=(4, 9)).astype(np.float32))
    t = torch.full((4, 1), 0.5)
    with torch.no_grad():
        projs = net.precompute(feat)
        a, b, c = (net.score_from(projs, pose, t, torch.Generator().manual_seed(s))
                   for s in (0, 0, 1))
        d = net.score_from(projs, pose, t)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_per_point_tails_need_rx_ry_and_t():
    with pytest.raises(NotImplementedError):
        PoseScoreNet(init_sde("ve").marginal_prob, regression_head="R_and_T",
                     per_point_feature=True)


@pytest.mark.parametrize("pose_mode", ["rot_matrix", "euler_xyz", "quat_xyzw"])
def test_reward_model_matches_jax(pose_mode):
    """The standalone reward MLP (JAX ``ranking.py::RewardModel``) for
    poses of each length; a pose of the wrong length raises."""
    from genpose_tpu.training.ranking import RewardModel as JaxReward
    from genpose_tpu_torch.training.ranking import RewardModel

    rng = np.random.default_rng(20)
    feat = rng.normal(size=(5, 1024)).astype(np.float32)
    pose = rng.normal(size=(5, tpose.get_pose_dim(pose_mode))).astype(np.float32)
    jnet = JaxReward(pose_mode=pose_mode)
    params, _ = _perturbed(jnet.init(jax.random.PRNGKey(4), jnp.asarray(feat),
                                     jnp.asarray(pose)), 21)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(feat), jnp.asarray(pose)))
    tnet = _load(RewardModel(pose_mode), params, {})
    with torch.no_grad():
        got = tnet(t_np(feat), t_np(pose))
        with pytest.raises(ValueError):
            tnet(t_np(feat), t_np(pose[:, :-1]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
