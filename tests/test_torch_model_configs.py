"""genpose_tpu_torch under every encoder, PointNet++ stage config and pose
mode of the JAX config, against the JAX package, on the CPU.

- **Composite model**: ``GFObjectPose`` score and energy (feature, head)
  for ``pts_encoder`` ``pointnet`` and ``pointnet_and_pointnet2``, and the
  Euler pose modes with the ``RT`` and ``R_and_T`` heads; rtol = atol =
  1e-5, as ``test_torch_models.py``.
- **Pipeline**: ``InferencePipeline`` against JAX's under Heun and RK45
  with pinned prior rows, for ``pointnet_and_pointnet2`` over ``full``
  with ``euler_xyz_sx_cx``, and for ``pointnet`` (no geometry) with
  ``euler_xyz``; 1e-4, as ``test_torch_serving.py``, the pooled quaternion
  up to sign.
- **Training**: one score step of ``pointnet_and_pointnet2`` over ``full``,
  loss and gradients leaf by leaf, held as
  ``test_torch_training.py::test_step_gradients_match_jax`` holds them.
- **Frozen**: ``freeze()`` equals eager bit for bit for ``pointnet`` (no
  geometry) and ``lighter`` (5 stages), with the geometry launches counted.
- **bfloat16**: ``full`` under ``compute_dtype="bfloat16"`` and
  ``encoder_f32_stages=-2`` (its last two of five stages float32), held as
  ``test_torch_bf16.py`` holds the ``light`` encoder and heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import Config
from genpose_tpu.models.posenet import GFObjectPose as JaxGF
from genpose_tpu.runners.serving import InferencePipeline as JaxPipeline
from genpose_tpu.training.agent import PoseAgent as JaxAgent
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.models import pointnet2 as tpn2
from genpose_tpu_torch.ops.pose import get_pose_dim
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training import frozen
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils.weights import from_jax_variables, perturb_
from _torch_parity import (derandomize_agent, jax_agent, pin_jax_prior, pin_port_prior,
                           port_agent, t_np, train_agent)

TOL = dict(rtol=1e-5, atol=1e-5)
PIPE_TOL = dict(rtol=1e-4, atol=1e-4)
N_PTS = 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch CPU thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pts(b, seed, n=N_PTS):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# composite model
# ---------------------------------------------------------------------------

MODELS = {
    "pointnet": dict(pts_encoder="pointnet"),
    "pointnet_and_pointnet2": dict(pts_encoder="pointnet_and_pointnet2"),
    "euler_xyz_RT": dict(pts_encoder="pointnet", pose_mode="euler_xyz", regression_head="RT"),
    "euler_xyz_R_and_T": dict(pts_encoder="pointnet", pose_mode="euler_xyz",
                              regression_head="R_and_T"),
    "euler_xyz_sx_cx_RT": dict(pts_encoder="pointnet", pose_mode="euler_xyz_sx_cx",
                               regression_head="RT"),
    "euler_xyz_sx_cx_R_and_T": dict(pts_encoder="pointnet", pose_mode="euler_xyz_sx_cx",
                                    regression_head="R_and_T"),
}


@pytest.mark.parametrize("mode", ["score", "energy"])
@pytest.mark.parametrize("name", list(MODELS))
def test_composite_model_matches_jax(name, mode):
    """The cloud feature and one head evaluation (per-row t), the score
    agent's EMA shadow or the energy agent's live params as the pipelines
    read them."""
    kw = dict(num_points=N_PTS, **MODELS[name])
    use_ema = mode == "score"
    ja = jax_agent(Config(**kw), mode, seed=3 if use_ema else 4)
    ta = port_agent(TorchConfig(**kw), mode, ja, use_ema=use_ema)
    st = ja.state
    v = {"params": st.ema.shadow if use_ema else st.params, "batch_stats": st.batch_stats}
    pts = _pts(4, 5)
    feat = ja.model.apply(v, jnp.asarray(pts), train=False, method=JaxGF.encode_pts)
    with torch.no_grad():
        got_feat = ta.model.encode_pts(t_np(pts))
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(feat), **TOL)
    rng = np.random.default_rng(6)
    pose = rng.normal(size=(4, get_pose_dim(kw.get("pose_mode", "rot_matrix")))).astype(np.float32)
    t = rng.uniform(1e-3, 1.0, size=(4, 1)).astype(np.float32)
    projs = ja.model.apply(v, feat, method=JaxGF.precompute_head)
    method = JaxGF.score_with if use_ema else JaxGF.energy_with
    want = ja.model.apply(v, projs, jnp.asarray(pose), jnp.asarray(t), method=method)
    with torch.no_grad():
        tp = ta.model.precompute_head(t_np(np.asarray(feat)))
        got = (ta.model.score_with if use_ema else ta.model.energy_with)(tp, t_np(pose), t_np(t))
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

PIPES = {
    "pn_pn2_full_euler_sx_cx": dict(pts_encoder="pointnet_and_pointnet2",
                                    pointnet2_params="full", pose_mode="euler_xyz_sx_cx",
                                    regression_head="R_and_T"),
    "pointnet_euler_xyz": dict(pts_encoder="pointnet", pose_mode="euler_xyz",
                               regression_head="RT"),
}


@pytest.mark.parametrize("name,sampler", [("pn_pn2_full_euler_sx_cx", "ode"),
                                          ("pn_pn2_full_euler_sx_cx", "ode_adaptive"),
                                          ("pointnet_euler_xyz", "ode")])
def test_pipeline_matches_jax(name, sampler):
    """A padded request of 3 clouds (batch 2, K=3, 3 Heun steps or RK45):
    every output against the JAX pipeline's with the same weights and prior
    rows."""
    kw = dict(num_points=N_PTS, batch_size=2, eval_repeat_num=3, sampling_steps=3, T0=0.55,
              sampler_mode=(sampler,), **PIPES[name])
    jp = JaxPipeline(Config(**kw))
    derandomize_agent(jp.score_agent, 7)
    derandomize_agent(jp.energy_agent, 8)
    noise = np.random.default_rng(9).normal(
        size=(2 * 3, get_pose_dim(kw["pose_mode"]))).astype(np.float32)
    pin_jax_prior(jp.score_agent, noise)
    tp = InferencePipeline(TorchConfig(**kw), device="cpu")
    ss, es = jp.score_agent.state, jp.energy_agent.state
    tp.score_agent.load_jax(jax.device_get(ss.ema.shadow), jax.device_get(ss.batch_stats))
    tp.energy_agent.load_jax(jax.device_get(es.params), jax.device_get(es.batch_stats))
    pin_port_prior(tp.score_agent, noise)
    rng = np.random.default_rng(10)
    pts = (rng.normal(size=(3, N_PTS, 3)) * 0.1 + rng.normal(size=(3, 1, 3))).astype(np.float32)
    want = jp.predict(pts, key=jax.random.PRNGKey(0))
    got = tp.predict(pts)
    assert set(got) == set(want)
    assert got["sorted_hypotheses"].shape == (3, 3, get_pose_dim(kw["pose_mode"]))
    for k in ("best_pose", "sorted_hypotheses", "energy"):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PIPE_TOL)
    q, wq = got["pred_pose"][:, :4], want["pred_pose"][:, :4]
    sign = np.sign(np.sum(q * wq, axis=1, keepdims=True))
    np.testing.assert_allclose(q * sign, wq, err_msg="pred_pose q", **PIPE_TOL)
    np.testing.assert_allclose(got["pred_pose"][:, 4:], want["pred_pose"][:, 4:], **PIPE_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_score_step_gradients_match_jax():
    """``pointnet_and_pointnet2`` over ``full``: the loss and the gradient
    each package hands its optimizer, leaf by leaf, within ``GRAD_TOL`` of
    the JAX leaf's norm (the float32 conditioning of
    ``test_torch_training.py``).  The loss is held at rtol 1e-4, not
    ``test_torch_training.py``'s 1e-5: ``full``'s first stage groups within
    r = 0.01, where a 128-point cloud leaves most balls holding their centre
    alone, so its channels' batch variance is tiny beside their mean and
    flax's E[x^2] - E[x]^2 loses digits that PyTorch's two-pass variance
    keeps (measured 3.7e-5)."""
    from test_torch_training import GRAD_TOL, _GradsOf, _batches, _cfgs, _j, _port, _t, dsm_noise

    jcfg, tcfg = _cfgs(pts_encoder="pointnet_and_pointnet2", pointnet2_params="full")
    ja = train_agent(jcfg, "score", seed=11)
    ta = _port(ja, tcfg, "score")
    b = _batches(1, seed=12)[0]
    key = jax.random.PRNGKey(13)
    st = jax.device_get(ja.state)
    want = jax.jit(lambda p, s, bt, k: ja._train_step_score_impl(_GradsOf(p, s), bt, k)[0])(
        st.params, st.batch_stats, _j(b), key)
    want_loss = float(ja.train_step(_j(b), key)["gf"])
    grabbed = {}
    ta.state.apply_gradients = lambda params, grads: grabbed.update(grads)
    got_loss = float(ta.train_step(_t(b), noise=dsm_noise(key, ja.sde.eps))["gf"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    want = from_jax_variables(jax.device_get(want), {})
    assert set(grabbed) == set(ta.params())
    floor = 1e-4 * max(float(g.norm()) for g in want.values())
    rel = {k: float((g - want[k]).norm()) / max(float(want[k].norm()), floor)
           for k, g in grabbed.items()}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_TOL, f"{worst}: {rel[worst]}"
    for enc in ("encoder_pn.", "encoder_pn2.", "fusion_layer."):
        assert sum(k.startswith(enc) and float(want[k].norm()) > floor for k in rel) > 0, enc


# ---------------------------------------------------------------------------
# frozen path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,geometry_stages", [("pointnet", 0), ("lighter", 4)])
def test_frozen_equals_eager(name, geometry_stages, monkeypatch):
    """Heun and RK45 samples and energies through ``freeze()`` equal eager
    bit for bit; the geometry runs eagerly outside the frozen programs, one
    FPS per FPS stage a call (none for the plain PointNet encoder)."""
    kw = (dict(pts_encoder="pointnet") if name == "pointnet" else
          dict(pointnet2_params=name))
    cfg = TorchConfig(num_points=N_PTS, **kw)
    score, energy = PoseAgent(cfg, "score", device="cpu"), PoseAgent(cfg, "energy", device="cpu")
    perturb_(score.model, seed=1)
    perturb_(energy.model, seed=2)
    fps_calls = []
    real_fps = tpn2.farthest_point_sample
    monkeypatch.setattr(tpn2, "farthest_point_sample",
                        lambda *a: fps_calls.append(1) or real_fps(*a))
    pts = torch.from_numpy(_pts(2, 14))
    batch = {"zero_mean_pts": pts - pts.mean(1, keepdim=True), "pts_center": pts.mean(1)}
    poses = torch.randn(2, 3, 9, generator=torch.Generator().manual_seed(15))

    def run():
        out = {s: score.sample(batch, torch.Generator().manual_seed(16), repeat_num=3,
                               sampler=s, num_steps=4, T0=0.55)
               for s in ("ode", "ode_adaptive")}
        out["energy"] = energy.get_energy(batch, poses, T=1e-5)
        return out

    eager = run()
    score.freeze()
    energy.freeze()
    n0, fps_calls[:] = frozen.dispatches, []
    got = run()
    assert frozen.dispatches == n0 + 3
    assert len(fps_calls) == 3 * geometry_stages
    for k in eager:
        assert torch.equal(got[k], eager[k]), k


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


def test_full_bf16_f32_stages_minus2_matches_jax():
    """``full`` (5 stages) under ``compute_dtype="bfloat16"`` and
    ``encoder_f32_stages=-2``: the feature (float32: the last stage is
    float32) and the score head within ``test_torch_bf16.py``'s MODULE_TOL
    of JAX under the same knobs, and at most CONTROL of the distance to the
    nearest wrong precision (float32 everywhere)."""
    from test_torch_bf16 import _check, _f32, _jax_model

    knobs = {"encoder_f32_stages": -2}
    ja = derandomize_agent(JaxAgent(Config(num_points=N_PTS, pointnet2_params="full"), "score"),
                           17)
    v = {"params": ja.state.ema.shadow, "batch_stats": ja.state.batch_stats}
    jm, jm32 = _jax_model(ja.model, knobs), _jax_model(ja.model, {}, bf16=False)
    pts = _pts(4, 18)
    ta = PoseAgent(TorchConfig(num_points=N_PTS, pointnet2_params="full",
                               compute_dtype="bfloat16", **knobs), "score", device="cpu")
    ta.load_jax(jax.device_get(v["params"]), jax.device_get(v["batch_stats"]))
    assert [m.dtype for m in (ta.model.encoder.sa_2.mlp_0.dense_0,
                              ta.model.encoder.sa_3.mlp_0.dense_0)] == [torch.bfloat16,
                                                                        torch.float32]

    def feat(model):
        return model.apply(v, jnp.asarray(pts), train=False, method=JaxGF.encode_pts)

    want = feat(jm)
    with torch.no_grad():
        got = ta.model.encode_pts(t_np(pts), geometry=ta.pts_geometry(t_np(pts)))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    _check("full -2 feature", got.numpy(), _f32(want), _f32(feat(jm32)))
    rng = np.random.default_rng(19)
    pose = rng.normal(size=(4, 9)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, size=(4, 1)).astype(np.float32)

    def head(model):
        projs = model.apply(v, want, method=JaxGF.precompute_head)
        return model.apply(v, projs, jnp.asarray(pose), jnp.asarray(t), method=JaxGF.score_with)

    with torch.no_grad():
        got_s = ta.model.score_with(ta.model.precompute_head(t_np(np.asarray(want))),
                                    t_np(pose), t_np(t))
    _check("full -2 score", got_s.float().numpy(), _f32(head(jm)), _f32(head(jm32)))
