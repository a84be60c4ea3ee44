"""genpose_tpu_torch samplers, ranking and pooling against the JAX package.

Both sides get the same weights (EMA shadow of a derandomised JAX score
agent), the same cloud feature and the same prior rows (each SDE's prior
pinned to return ``noise``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import Config
from genpose_tpu.diffusion.samplers import ode_sampler as jax_ode
from genpose_tpu.diffusion.samplers import ode_sampler_adaptive as jax_ode_adaptive
from genpose_tpu.models.posenet import GFObjectPose as JaxGF
from genpose_tpu.training.ranking import sort_poses_by_energy as jax_sort
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.diffusion.samplers import ode_sampler, ode_sampler_adaptive
from genpose_tpu_torch.training.ranking import sort_poses_by_energy
from _torch_parity import jax_agent, port_agent, t_np

B, K, N_POINTS, T0 = 2, 3, 64, 0.55


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = Config(num_points=N_POINTS), TorchConfig(num_points=N_POINTS)
    js = jax_agent(cfg, "score", seed=1)
    ts = port_agent(tcfg, "score", js, use_ema=True)
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(B, N_POINTS, 3)) * 0.1).astype(np.float32)
    st = js.state
    feat = js.model.apply({"params": st.ema.shadow, "batch_stats": st.batch_stats},
                          jnp.asarray(pts), train=False, method=JaxGF.encode_pts)
    noise = rng.normal(size=(B * K, 9)).astype(np.float32)
    center = np.repeat(rng.normal(size=(B, 3)).astype(np.float32) * 0.3, K, axis=0)
    jsde = dataclasses.replace(js.sde, prior=lambda key, shape, T=None: jnp.asarray(noise))
    tsde = dataclasses.replace(
        ts.sde, prior=lambda shape, T=None, generator=None, device=None: t_np(noise))
    return {
        "jscore": js._head_score_fn(st.ema.shadow, st.batch_stats, feat, repeat=K),
        "tscore": ts._head_score_fn(t_np(np.asarray(feat)), repeat=K),
        "jsde": jsde, "tsde": tsde, "center": center,
    }


def test_heun_ode_sampler_matches_jax(setup):
    """Fixed-step Heun, 6 steps from T0=0.55.  rtol = atol = 1e-5: the same
    float32 steps on both sides, apart from GEMM summation order."""
    s = setup
    run = jax.jit(lambda: jax_ode(s["jscore"], jax.random.PRNGKey(0), B * K, s["jsde"],
                                  num_steps=6, T0=T0, pts_center=jnp.asarray(s["center"]))[1])
    want = np.asarray(run())
    with torch.no_grad():
        got = ode_sampler(s["tscore"], B * K, s["tsde"], num_steps=6, T0=T0,
                          pts_center=t_np(s["center"])).numpy()
    assert got.shape == (B * K, 9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_adaptive_ode_sampler_matches_jax(setup):
    """Dormand-Prince RK45 at atol = rtol = 1e-5.  An accept/reject decision
    with err close to 1 can flip between the two frameworks' roundings, and
    then the paths differ by up to the solver's own error control.  Each
    accepted step keeps its local error under ~1e-5 of the state, so the
    bound is 1e-5 per step taken, times a safety factor of 2."""
    s = setup
    run = jax.jit(lambda: jax_ode_adaptive(
        s["jscore"], jax.random.PRNGKey(0), B * K, s["jsde"], T0=T0,
        pts_center=jnp.asarray(s["center"]), return_stats=True)[1:])
    want, jstats = run()
    want = np.asarray(want)
    with torch.no_grad():
        got, tstats = ode_sampler_adaptive(s["tscore"], B * K, s["tsde"], T0=T0,
                                           pts_center=t_np(s["center"]),
                                           return_stats=True)
    n_jax, n_port = int(jstats["n_steps"]), tstats["n_steps"]
    print(f"adaptive RK45 attempts: jax {n_jax}, port {n_port}")
    assert bool(jstats["converged"]) and tstats["converged"]
    assert abs(n_jax - n_port) <= 2
    tol = 2 * 1e-5 * max(n_jax, n_port)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("sampler", ["ode", "ode_adaptive"])
def test_samplers_start_from_init_x_as_jax(setup, sampler):
    """Tracking's prior: the integration starts at ``init_x`` + the prior
    draw at T0 = 0.15 (JAX ``samplers.py:69`` and the adaptive sampler's
    ``x0``).  rtol = atol = 1e-5 for both samplers."""
    s = setup
    init_x = np.random.default_rng(5).normal(size=(B * K, 9)).astype(np.float32)
    kw = dict(T0=0.15, init_x=init_x)
    if sampler == "ode":
        run = jax.jit(lambda: jax_ode(s["jscore"], jax.random.PRNGKey(0), B * K, s["jsde"],
                                      num_steps=6, pts_center=jnp.asarray(s["center"]),
                                      **kw)[1])
        port = lambda **k: ode_sampler(s["tscore"], B * K, s["tsde"], num_steps=6, **k)  # noqa: E731
    else:
        run = jax.jit(lambda: jax_ode_adaptive(s["jscore"], jax.random.PRNGKey(0), B * K,
                                               s["jsde"], pts_center=jnp.asarray(s["center"]),
                                               **kw)[1])
        port = lambda **k: ode_sampler_adaptive(s["tscore"], B * K, s["tsde"], **k)  # noqa: E731
    want = np.asarray(run())
    with torch.no_grad():
        got = port(T0=0.15, init_x=t_np(init_x), pts_center=t_np(s["center"])).numpy()
        without = port(T0=0.15, pts_center=t_np(s["center"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - without).max() > 0.1  # init_x moved the start


def test_sort_poses_by_energy_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    poses = rng.normal(size=(3, 8, 9)).astype(np.float32)
    energy = rng.integers(0, 3, size=(3, 8, 2)).astype(np.float32)  # many ties
    energy[1] = 0.5  # all tied: stable order keeps index order
    want = jax_sort(jnp.asarray(poses), jnp.asarray(energy))
    got = sort_poses_by_energy(t_np(poses), t_np(energy))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][1].numpy(), poses[1])


def test_aggregate_hypotheses_matches_jax():
    """Per-hypothesis quaternions to float noise; the pooled quaternion up to
    sign (eigh's eigenvector sign is fixed by w, which leaves w == 0 open)."""
    from genpose_tpu.ops.pose import matrix_to_rot6d as jax_m2r6d
    from genpose_tpu.training.agent import PoseAgent as JaxAgent

    from genpose_tpu_torch.training.agent import PoseAgent as TorchAgent

    rng = np.random.default_rng(4)
    # hypotheses scattered around one rotation, as a converged sampler gives
    base = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rots = []
    for _ in range(2 * 5):
        q = np.linalg.qr(base + 0.2 * rng.normal(size=(3, 3)))[0]
        rots.append(q * np.sign(np.linalg.det(q)))
    rot6d = np.asarray(jax_m2r6d(jnp.asarray(np.stack(rots), jnp.float32)))
    pred = np.concatenate([rot6d, rng.normal(size=(10, 3))], -1).reshape(2, 5, 9)
    pred = pred.astype(np.float32)
    jq, javg = JaxAgent.aggregate_hypotheses(
        type("A", (), {"cfg": Config()})(), jnp.asarray(pred))
    tq, tavg = TorchAgent.aggregate_hypotheses(
        type("A", (), {"cfg": TorchConfig()})(), t_np(pred))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    javg, tavg = np.asarray(javg), tavg.numpy()
    np.testing.assert_allclose(tavg[:, 4:], javg[:, 4:], rtol=1e-5, atol=1e-6)
    sign = np.sign(np.sum(tavg[:, :4] * javg[:, :4], axis=1, keepdims=True))
    np.testing.assert_allclose(tavg[:, :4] * sign, javg[:, :4], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(tavg[:, :4], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("sampler", ["ode", "ode_adaptive"])
def test_samplers_build_their_state_where_their_inputs_are(sampler, monkeypatch):
    """With no ``device``, a sampler works on ``pts_center``'s device, else
    on ``generator``'s; with neither it asks for the card, which raises here
    (no silent fallback to the CPU)."""
    from genpose_tpu_torch.diffusion.sde import init_sde

    sde = init_sde("ve")
    seen = []

    def score_fn(x, t):
        seen.append(x.device)
        return torch.zeros_like(x)

    run = {"ode": lambda **kw: ode_sampler(score_fn, 4, sde, num_steps=3, T0=T0, **kw),
           "ode_adaptive": lambda **kw: ode_sampler_adaptive(score_fn, 4, sde, T0=T0, **kw)}
    out = run[sampler](pts_center=torch.zeros(4, 3))
    assert out.device.type == "cpu" and out.shape == (4, 9) and torch.isfinite(out).all()
    out = run[sampler](generator=torch.Generator().manual_seed(0))
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert seen and all(d.type == "cpu" for d in seen)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run[sampler]()
