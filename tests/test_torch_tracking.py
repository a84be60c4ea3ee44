"""genpose_tpu_torch tracking (utils/tracking.py, runners/evaluation_tracking.py)
against the JAX package.

- ``add_noise_to_RT`` given the draws the JAX function makes from a key
  equals the JAX function within 1e-6 (float32 quaternion arithmetic).
- ``main_tracking`` over three frames: both runners get the same weights,
  the same prior rows (each score agent's prior pinned to the first rows of
  ``NOISE``; both runners pad a frame to a power of two with copies of its
  last instance, each padded row with its own prior rows) and the same pose
  noise (the port is handed the draws of the JAX runner's keys).  The
  pooled pose of every instance of every frame agrees within 1e-4, the
  serving tolerance, and so do the metrics.  Frames after the first start
  from the previous frame's pooled pose, so a fault in the ``init_x`` + T0
  prior shows in frames 2 and 3.
- The same under the adaptive RK45 sampler on a tree of three objects a
  scene, whose frames of three instances are padded to four: RK45 takes one
  step size for all rows, so the padding is part of the real rows' result.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import get_config as jax_get_config
from genpose_tpu.runners import evaluation_tracking as jtr
from genpose_tpu.utils import tracking as jtrk
from genpose_tpu_torch.config import get_config
from genpose_tpu_torch.data import synthetic
from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results, make_synthetic_nocs_dir
from genpose_tpu_torch.runners import evaluation_tracking as ttr
from genpose_tpu_torch.utils import tracking as ttrk
from _torch_parity import jax_agent, pin_jax_prior, pin_port_prior, port_agent

K, T0 = 5, 0.15
FLAGS = ["--test_source", "real_test", "--num_points", "128", "--eval_repeat_num", str(K),
         "--sampling_steps", "6", "--T0", str(T0), "--batch_size", "4"]
NOISE = np.random.default_rng(1).normal(size=(8 * K, 9)).astype(np.float32)


def _jax_draws(key, B, r_deg=5.0, t=0.03):
    """The draws ``genpose_tpu.utils.tracking.add_noise_to_RT`` makes from
    ``key`` ("normal" noise), as the port's ``draws``."""
    k_theta, k_dir, k_norm, k_q = jax.random.split(key, 4)
    rad = r_deg / 180.0 * jnp.pi
    return tuple(torch.from_numpy(np.array(x)) for x in (
        jnp.abs(jax.random.normal(k_theta, (B,))) * rad,
        jax.random.normal(k_norm, (B,)) * t,
        jax.random.normal(k_dir, (B, 3)),
        jax.random.normal(k_q, (B, 4))))


def _poses(rng, B):
    from scipy.spatial.transform import Rotation

    rt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    rt[:, :3, :3] = Rotation.random(B, random_state=int(rng.integers(1 << 30))).as_matrix()
    rt[:, :3, 3] = rng.normal(size=(B, 3))
    return rt


def test_add_noise_to_rt_with_jax_draws():
    rng = np.random.default_rng(0)
    for n, B in enumerate((3, 9)):
        rt = _poses(rng, B)
        key = jax.random.PRNGKey(n)
        want = np.asarray(jtrk.add_noise_to_RT(key, jnp.asarray(rt)))
        got = ttrk.add_noise_to_RT(torch.from_numpy(rt), draws=_jax_draws(key, B)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # the noise moved the pose: rotations by up to ~15 deg, translations by cm
        assert not np.allclose(got, rt, atol=1e-4)
        np.testing.assert_allclose(got[:, :3, :3] @ got[:, :3, :3].transpose(0, 2, 1),
                                   np.tile(np.eye(3), (B, 1, 1)), atol=1e-5)


def test_add_noise_to_rt_from_a_generator():
    rt = torch.from_numpy(_poses(np.random.default_rng(2), 64))
    a = ttrk.add_noise_to_RT(rt, generator=torch.Generator().manual_seed(0))
    b = ttrk.add_noise_to_RT(rt, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, rt)
    shift = torch.linalg.norm(a[:, :3, 3] - rt[:, :3, 3], dim=1)
    assert 0.005 < float(shift.mean()) < 0.05  # |N(0, 1)| * 3 cm on average ~2.4 cm


def test_jitter_and_pose9d_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    theta = rng.uniform(0, 0.3, (6, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jtrk.jitter_quaternion(key, jnp.asarray(q), jnp.asarray(theta)))
    rand_q = torch.from_numpy(np.array(jax.random.normal(key, q.shape)))
    got = ttrk.jitter_quaternion(torch.from_numpy(q), torch.from_numpy(theta), rand_q).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rt = _poses(rng, 5)
    np.testing.assert_array_equal(ttrk.srt_to_pose9d(torch.from_numpy(rt)).numpy(),
                                  np.asarray(jtrk.srt_to_pose9d(jnp.asarray(rt))))


def _track_both(root, extra=()):
    """``main_tracking`` of both runners on the tree under ``root``; returns
    the pooled poses each handed ``compute_RT_errors``, both metrics and the
    port's instance count of each frame."""
    nocs = str(root / "nocs")
    for side in ("jax", "port"):
        make_synthetic_mrcnn_results(nocs, str(root / side), "real_test", tracking=True)
    flags = FLAGS + list(extra)
    jcfg = jax_get_config(["--data_path", nocs, "--result_dir", str(root / "jax")] + flags)
    tcfg = get_config(["--data_path", nocs, "--result_dir", str(root / "port")] + flags)

    js, je = jax_agent(jcfg, "score", seed=3), jax_agent(jcfg, "energy", seed=4)
    ts, te = port_agent(tcfg, "score", js, use_ema=True), port_agent(tcfg, "energy", je, False)
    pin_jax_prior(js, NOISE)
    pin_port_prior(ts, NOISE)

    out, counts, track_frame = {"jax": [], "port": []}, [], ttr.track_frame

    def counted(cfg, s, e, batch, *args):
        counts.append(batch["zero_mean_pts"].shape[0])
        return track_frame(cfg, s, e, batch, *args)

    def recorder(mod, side):
        real = mod.compute_RT_errors

        def rec(sRT, gt, cat_id, hv, names):
            out[side].append(np.array(sRT, np.float64))
            return real(sRT, gt, cat_id, hv, names)
        return rec

    # the JAX runner's key sequence: per frame, (key, k_noise) then (key, k_sample)
    key, jax_noise = jax.random.PRNGKey(jcfg.seed), []
    for _ in range(3):
        key, k_n = jax.random.split(key)
        jax_noise.append(k_n)
        key, _ = jax.random.split(key)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtr, "PoseAgent", lambda cfg, mode: js if mode == "score" else je)
        mp.setattr(jtr, "compute_RT_errors", recorder(jtr, "jax"))
        mp.setattr(ttr, "compute_RT_errors", recorder(ttr, "port"))
        mp.setattr(ttr, "track_frame", counted)
        jm = jtr.main_tracking(jcfg, tracking=True, T0=T0)
        tm = ttr.main_tracking(tcfg, tracking=True, T0=T0, score_agent=ts, energy_agent=te,
                               noise_draws=lambda frame, n: _jax_draws(jax_noise[frame], n))
    finally:
        mp.undo()
    return out, jm, tm, counts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracking")
    make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1, n_real_scenes=3, seed=13)
    return _track_both(root)


@pytest.fixture(scope="module")
def runs_rk45(tmp_path_factory):
    """Three objects a scene: ``render_scene`` draws two by default."""
    root = tmp_path_factory.mktemp("tracking_rk45")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(synthetic, "render_scene",
                   functools.partial(synthetic.render_scene, n_instances=3))
        make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1, n_real_scenes=3,
                                seed=13)
    finally:
        mp.undo()
    return _track_both(root, ["--sampler_mode", "ode_adaptive"])


def _check_pooled_poses(out):
    for n, (got, want) in enumerate(zip(out["port"], out["jax"])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"instance {n}")
        np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3), atol=1e-5)


def test_main_tracking_pooled_poses_match_jax(runs):
    out, _, _, _ = runs
    assert len(out["port"]) == len(out["jax"]) >= 4  # 3 frames of 1-2 instances
    _check_pooled_poses(out)


def test_main_tracking_pooled_poses_match_jax_rk45(runs_rk45):
    out, _, _, counts = runs_rk45
    assert any(n & (n - 1) for n in counts), counts  # a frame is padded
    assert len(out["port"]) == len(out["jax"]) == sum(counts)
    _check_pooled_poses(out)


def test_main_tracking_metrics_match_jax(runs):
    _, jm, tm, _ = runs
    assert list(tm) == list(jm) and "all" in tm
    for name in jm:
        np.testing.assert_allclose(tm[name]["mean_error"], jm[name]["mean_error"],
                                   rtol=1e-4, atol=1e-4)
        assert tm[name]["5d5cm_acc"] == jm[name]["5d5cm_acc"]


def test_cal_average_srt_matches_jax():
    """float32 4x4 eigen-solves on both sides: within a few ulp of 1."""
    rng = np.random.default_rng(5)
    srt = np.stack([_poses(rng, 6) for _ in range(3)])  # [bs=3, K=6, 4, 4]
    np.testing.assert_allclose(ttr.cal_average_sRT(srt, 4), jtr.cal_average_sRT(srt, 4),
                               rtol=0, atol=1e-5)


def test_aggregate_tracking_metrics_matches_jax():
    rng = np.random.default_rng(6)
    errors = {f"{c}_{i}": rng.uniform(0, 10, (int(rng.integers(1, 5)), 2)).tolist()
              for c in ("mug", "bowl") for i in range(2)}
    want, got = jtr.aggregate_tracking_metrics(errors), ttr.aggregate_tracking_metrics(errors)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k]["mean_error"], want[k]["mean_error"])
        assert got[k]["5d5cm_acc"] == want[k]["5d5cm_acc"]
