"""The port's VP / sub-VP / EDM SDEs, its PC, EDM, Euler / RK4 and
likelihood samplers, the EDM decoder head and loss, and the agent and
pipeline paths over them, against the JAX package on the CPU.

Both sides get the same weights (derandomised JAX agents, the score agent's
EMA shadow for sampling) and the same draws: the prior rows are pinned on
both sides, and every draw the JAX code makes from a key (PC's per-step
corrector and predictor noise, EDM's unit latents, the EDM loss's sigma and
z, ``get_energy``'s t, the Hutchinson probe) is re-derived from the same key
splits here and handed to the port.

Tolerances: the same float32 chain on both sides, apart from GEMM
summation order and the pow / exp / log implementations (~1e-7 relative per
op), carried through at most 10 sampler steps: rtol = atol = 1e-5 for the
schedules and single head evaluations, 1e-4 (scaled by magnitude) for
sampler chains, the likelihood and the pipelines.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import Config
from genpose_tpu.diffusion import losses as jlosses
from genpose_tpu.diffusion import samplers as jsamplers
from genpose_tpu.diffusion import sde as jsde_mod
from genpose_tpu.models.layers import PositionalEmbedding as JaxPositionalEmbedding
from genpose_tpu.models.posenet import GFObjectPose as JaxGF
from genpose_tpu.runners.serving import InferencePipeline as JaxPipeline
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.diffusion import losses, samplers
from genpose_tpu_torch.diffusion import sde as sde_mod
from genpose_tpu_torch.models.layers import PositionalEmbedding
from genpose_tpu_torch.runners.serving import InferencePipeline
from _torch_parity import (
    derandomize_agent,
    jax_agent,
    pin_jax_prior,
    pin_port_prior,
    port_agent,
    t_np,
)

B, K, N_POINTS, STEPS = 2, 3, 64, 6
ROWS = B * K
TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = 1e-4  # |port - jax| / (1 + |jax|)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and the many small ops of the
    samplers slow down severely when every worker runs a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=CHAIN_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    diff = np.max(np.abs(got - want) / (1.0 + np.abs(want)))
    assert diff <= tol, f"{what}: max scaled diff {diff} > {tol}"


# ---------------------------------------------------------------------------
# schedules and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ve", "vp", "subvp", "edm"])
def test_sde_matches_jax(mode):
    """marginal_prob (mean and std, and the std-only query), sde and the
    T-aware prior with injected noise; eps and T.  rtol = atol = 1e-5."""
    j, t = jsde_mod.init_sde(mode), sde_mod.init_sde(mode)
    assert (t.eps, t.T) == (j.eps, j.T)
    rng = np.random.default_rng(0)
    lo = 0.002 if mode == "edm" else j.eps
    times = np.concatenate([[lo, j.T], rng.uniform(lo, j.T, size=6)]).astype(np.float32)
    times = times.reshape(-1, 1)
    x = rng.normal(size=(8, 9)).astype(np.float32)
    jm, js = j.marginal_prob(jnp.asarray(x), jnp.asarray(times))
    tm, ts = t.marginal_prob(t_np(x), t_np(times))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(np.broadcast_to(ts.numpy(), (8, 1)),
                               np.broadcast_to(np.asarray(js), (8, 1)), **TOL)
    _, ts0 = t.marginal_prob(None, t_np(times))
    np.testing.assert_allclose(np.broadcast_to(ts0.numpy(), (8, 1)),
                               np.broadcast_to(np.asarray(js), (8, 1)), **TOL)
    jd, jg = j.sde(jnp.asarray(times))
    td, tg = t.sde(t_np(times))
    np.testing.assert_allclose(np.broadcast_to(td.numpy(), (8, 1)),
                               np.broadcast_to(np.asarray(jd), (8, 1)), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    z = rng.normal(size=(8, 9)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    zj = np.asarray(jax.random.normal(key, (8, 9)))
    for T in (None, 0.55, j.T):
        kw = {} if T is None else {"T": T}
        want = np.asarray(j.prior(key, (8, 9), **kw))
        got = t.prior((8, 9), noise=t_np(zj), **kw).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert t.prior((8, 9), generator=torch.Generator().manual_seed(0)).shape == (8, 9)
    assert torch.equal(t.prior((8, 9), T=j.T, noise=t_np(z)),
                       t.prior((8, 9), T=j.T, noise=t_np(z)))


def test_positional_embedding_matches_jax():
    x = np.random.default_rng(1).normal(size=(7,)).astype(np.float32) * 3.0
    for endpoint in (False, True):
        j = JaxPositionalEmbedding(num_channels=128, endpoint=endpoint)
        want = np.asarray(j.apply({}, jnp.asarray(x)))
        got = PositionalEmbedding(128, endpoint=endpoint)(t_np(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# shared agents (module scope: the JAX jits compile once)
# ---------------------------------------------------------------------------


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, N_POINTS, 3)) * 0.1).astype(np.float32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pts = _cloud(B, seed)
    center = (rng.normal(size=(B, 3)) * 0.3).astype(np.float32)
    return {"zero_mean_pts": pts, "pts_center": center}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: t_np(v) for k, v in batch.items()}


def _head_fns(jag, tag, feat_pts, repeat):
    """(jax score_fn, port score_fn, jax denoise_fn, port denoise_fn) over the
    EMA shadow's cloud feature of ``feat_pts``."""
    st = jag.state
    variables = {"params": st.ema.shadow, "batch_stats": st.batch_stats}
    feat = jag.model.apply(variables, jnp.asarray(feat_pts), train=False,
                           method=JaxGF.encode_pts)
    tfeat = t_np(np.asarray(feat))
    return (jag._head_score_fn(st.ema.shadow, st.batch_stats, feat, repeat=repeat),
            tag._head_score_fn(tfeat, repeat=repeat),
            jag._head_denoise_fn(st.ema.shadow, st.batch_stats, feat, repeat=repeat),
            tag._head_denoise_fn(tfeat, repeat=repeat))


@pytest.fixture(scope="module")
def ve():
    cfg = Config(num_points=N_POINTS)
    jag = jax_agent(cfg, "score", seed=1)
    tag = port_agent(TorchConfig(num_points=N_POINTS), "score", jag, use_ema=True)
    js, ts, _, _ = _head_fns(jag, tag, _cloud(B, 0), K)
    return {"jag": jag, "tag": tag, "jscore": js, "tscore": ts}


@pytest.fixture(scope="module")
def edm():
    cfg = Config(num_points=N_POINTS, sde_mode="edm")
    jag = jax_agent(cfg, "score", seed=3)
    tag = port_agent(TorchConfig(num_points=N_POINTS, sde_mode="edm"), "score", jag,
                     use_ema=True)
    assert tag.is_edm and tag.model.decoder_head
    js, ts, jd, td = _head_fns(jag, tag, _cloud(B, 0), K)
    return {"jag": jag, "tag": tag, "jscore": js, "tscore": ts, "jden": jd, "tden": td}


def test_decoder_net_matches_jax(edm):
    """PoseDecoderNet: denoiser and implied score at per-row and
    step-shared sigma.  rtol = atol = 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(ROWS, 9)).astype(np.float32)
    for sigma in (rng.uniform(0.002, 80.0, size=(ROWS, 1)), np.full((1, 1), 0.37)):
        sigma = sigma.astype(np.float32)
        want = np.asarray(edm["jden"](jnp.asarray(x), jnp.asarray(sigma)))
        got = edm["tden"](t_np(x), t_np(sigma))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        want = np.asarray(edm["jscore"](jnp.asarray(x), jnp.asarray(sigma)))
        got = edm["tscore"](t_np(x), t_np(sigma))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # D(x, sigma) = x + sigma f and s = f / sigma, so D = x + sigma^2 s
    sigma = t_np(np.full((ROWS, 1), 0.5, np.float32))
    d, s = edm["tden"](t_np(x), sigma), edm["tscore"](t_np(x), sigma)
    np.testing.assert_allclose(d.numpy(), (t_np(x) + 0.25 * s).numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# samplers at the function level
# ---------------------------------------------------------------------------


def _pinned(sde_j, sde_t, noise):
    return (dataclasses.replace(sde_j, prior=lambda key, shape, T=None: jnp.asarray(noise)),
            dataclasses.replace(sde_t, prior=lambda shape, T=None, generator=None,
                                device=None: t_np(noise)))


@pytest.mark.parametrize("integrator,mode", [("euler", "subvp"), ("rk4", "vp"),
                                             ("heun", "edm")])
def test_ode_sampler_integrators_and_process_match_jax(ve, integrator, mode):
    """Euler, RK4 and Heun steps over the VE score head under the sub-VP, VP
    (drift coefficient non-zero) and EDM schedules, from T0 with the
    trajectory (``return_process``): poses and every state of the
    trajectory within 1e-4 scaled."""
    rng = np.random.default_rng(4)
    noise = rng.normal(size=(ROWS, 9)).astype(np.float32)
    center = rng.normal(size=(ROWS, 3)).astype(np.float32)
    jsde, tsde = _pinned(jsde_mod.init_sde(mode), sde_mod.init_sde(mode), noise)
    T0 = 0.55 if mode != "edm" else 2.0
    run = jax.jit(lambda: jsamplers.ode_sampler(
        ve["jscore"], jax.random.PRNGKey(0), ROWS, jsde, num_steps=STEPS, T0=T0,
        pts_center=jnp.asarray(center), integrator=integrator, return_process=True))
    jproc, jx = run()
    with torch.no_grad():
        tproc, tx = samplers.ode_sampler(ve["tscore"], ROWS, tsde, num_steps=STEPS, T0=T0,
                                         pts_center=t_np(center), integrator=integrator,
                                         return_process=True)
    assert tproc.shape == (ROWS, STEPS, 9)
    _close(tx, jx, what="poses")
    _close(tproc, jproc, what="trajectory")


def _pc_draws(key, num_steps, shape):
    """The draws JAX's pc_sampler makes from ``key``: (corrector, predictor),
    each [num_steps, *shape] (``k_prior, k_scan = split(key)``; ``split(k_scan,
    num_steps)``; each step ``k1, k2 = split(k)``)."""
    _, k_scan = jax.random.split(key)
    z1, z2 = [], []
    for k in jax.random.split(k_scan, num_steps):
        k1, k2 = jax.random.split(k)
        z1.append(np.asarray(jax.random.normal(k1, shape)))
        z2.append(np.asarray(jax.random.normal(k2, shape)))
    return t_np(np.stack(z1)), t_np(np.stack(z2))


@pytest.mark.parametrize("start", ["full_ladder", "T0_init_x"])
def test_pc_sampler_matches_jax(ve, start):
    """Predictor-corrector under VE with JAX's per-step draws injected:
    the full ladder from T (prior pinned) and the T0 = 0.55 start from
    ``init_x`` + prior; poses and trajectory within 1e-4 scaled."""
    rng = np.random.default_rng(5)
    noise = rng.normal(size=(ROWS, 9)).astype(np.float32)
    center = rng.normal(size=(ROWS, 3)).astype(np.float32)
    init_x = rng.normal(size=(ROWS, 9)).astype(np.float32)
    jsde, tsde = _pinned(ve["jag"].sde, sde_mod.init_sde("ve"), noise)
    key = jax.random.PRNGKey(7)
    kw = {} if start == "full_ladder" else {"T0": 0.55}
    run = jax.jit(lambda init: jsamplers.pc_sampler(
        ve["jscore"], key, ROWS, jsde, num_steps=STEPS, pts_center=jnp.asarray(center),
        return_process=True, init_x=init, **kw))
    jinit = None if start == "full_ladder" else jnp.asarray(init_x)
    jproc, jx = run(jinit)
    with torch.no_grad():
        tproc, tx = samplers.pc_sampler(
            ve["tscore"], ROWS, tsde, num_steps=STEPS, pts_center=t_np(center),
            return_process=True, init_x=None if jinit is None else t_np(init_x),
            noise=_pc_draws(key, STEPS, (ROWS, 9)), **kw)
    _close(tx, jx, what="poses")
    _close(tproc, jproc, what="trajectory")


def test_pc_sampler_zero_score_guard():
    """A zero score (a fresh, zero-initialised head) makes the corrector a
    no-op instead of an infinite step: finite, and equal to JAX's guard
    with the same draws (rtol = atol = 1e-5)."""
    x0 = np.random.default_rng(1).normal(size=(4, 9)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = jsamplers.pc_sampler(lambda x, t: jnp.zeros_like(x), key, 4,
                                jsde_mod.init_sde("ve"), num_steps=3,
                                init_x=jnp.asarray(x0))[1]
    got = samplers.pc_sampler(lambda x, t: torch.zeros_like(x), 4, sde_mod.init_sde("ve"),
                              num_steps=3, init_x=t_np(x0), device="cpu",
                              noise=_pc_draws(key, 3, (4, 9)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("start", ["latents", "T0_init_x", "churn"])
def test_edm_sampler_matches_jax(edm, start):
    """EDM Heun sampler over the decoder head, 5 steps: from injected
    ``latents`` at sigma_max; from ``init_x`` + latents at the sigma of
    T0 = 0.55; and with S_churn = 2 (noise added at each step, JAX's
    per-step draws injected); poses and trajectory within 1e-4 scaled."""
    rng = np.random.default_rng(6)
    latents = rng.normal(size=(ROWS, 9)).astype(np.float32)
    center = rng.normal(size=(ROWS, 3)).astype(np.float32)
    init_x = rng.normal(size=(ROWS, 9)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    kw, tkw = {}, {}
    if start == "T0_init_x":
        kw["T0"] = 0.55
    if start == "churn":
        kw.update(S_churn=2.0, S_min=0.05, S_max=50.0)
        _, k_scan = jax.random.split(key)
        tkw["noise"] = t_np(np.stack([np.asarray(jax.random.normal(k, (ROWS, 9)))
                                      for k in jax.random.split(k_scan, 5)]))
    jinit = None if start != "T0_init_x" else jnp.asarray(init_x)
    run = jax.jit(lambda init: jsamplers.edm_sampler(
        edm["jden"], key, ROWS, num_steps=5, pts_center=jnp.asarray(center),
        return_process=True, latents=jnp.asarray(latents), init_x=init, **kw))
    jproc, jx = run(jinit)
    with torch.no_grad():
        tproc, tx = samplers.edm_sampler(
            edm["tden"], ROWS, num_steps=5, pts_center=t_np(center), return_process=True,
            latents=t_np(latents), init_x=None if jinit is None else t_np(init_x), **kw, **tkw)
    assert tproc.shape == (ROWS, 5, 9)
    _close(tx, jx, what="poses")
    _close(tproc, jproc, what="trajectory")


@pytest.mark.parametrize("divergence", ["exact", "hutchinson"])
def test_ode_likelihood_matches_jax(ve, divergence):
    """The joint (x, log p) Heun integration, 6 steps from eps to T, with the
    exact divergence and with an injected Hutchinson probe: latents and
    bits within 1e-4 scaled.  The score closes over one cloud (3 rows)."""
    jag, tag = ve["jag"], ve["tag"]
    js, ts, _, _ = _head_fns(jag, tag, _cloud(1, 8), 3)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 9)).astype(np.float32)
    eps = rng.normal(size=(3, 9)).astype(np.float32)
    exact = divergence == "exact"
    run = jax.jit(lambda: jsamplers.ode_likelihood(
        js, jax.random.PRNGKey(0), jnp.asarray(x), jag.sde, num_steps=STEPS,
        exact_divergence=exact, epsilon=jnp.asarray(eps)))
    jz, jbits = run()
    tz, tbits = samplers.ode_likelihood(ts, t_np(x), tag.sde, num_steps=STEPS,
                                        exact_divergence=exact, epsilon=t_np(eps))
    _close(tz, jz, what="latent")
    _close(tbits, jbits, what="bits")


# ---------------------------------------------------------------------------
# EDM loss
# ---------------------------------------------------------------------------


def _edm_draw(key, bs, pose_dim=9, sigma_min=0.002, sigma_max=80.0):
    """The draw JAX's edm_dsm_loss makes from ``key``: (sigma [bs, 1], z [bs,
    pose_dim]), sigma log-uniform as it computes it."""
    k_t, k_z = jax.random.split(key)
    u = jax.random.uniform(k_t, (bs, 1))
    sigma = jnp.exp(jnp.log(sigma_min) + u * (jnp.log(sigma_max) - jnp.log(sigma_min)))
    return np.asarray(sigma), np.asarray(jax.random.normal(k_z, (bs, pose_dim)))


def _edm_draws(key, repeat, bs):
    """The draws of JAX's edm_dsm_loss_repeated from ``key`` (one key per
    draw): (sigma [repeat, bs, 1], z [repeat, bs, pose_dim])."""
    draws = [_edm_draw(k, bs) for k in jax.random.split(key, repeat)]
    return tuple(t_np(np.stack(d)) for d in zip(*draws))


def test_edm_loss_matches_jax():
    """The EDM loss over a fixed linear denoiser with JAX's draws, one draw
    and three: rtol 1e-5."""
    rng = np.random.default_rng(10)
    w = rng.normal(size=(9, 9)).astype(np.float32) * 0.1
    gt = rng.normal(size=(4, 9)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = float(jlosses.edm_dsm_loss_repeated(
        lambda x, s: x @ jnp.asarray(w) + s * 0.1, key, jnp.asarray(gt), 3))
    got = float(losses.edm_dsm_loss_repeated(
        lambda x, s: x @ t_np(w) + s * 0.1, t_np(gt), 3, noise=_edm_draws(key, 3, 4)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = float(jlosses.edm_dsm_loss(lambda x, s: x @ jnp.asarray(w), key, jnp.asarray(gt)))
    got = float(losses.edm_dsm_loss(lambda x, s: x @ t_np(w), t_np(gt),
                                    noise=tuple(t_np(d) for d in _edm_draw(key, 4))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    sig, _ = losses.draw_edm_noise(3, 4, 9, generator=torch.Generator().manual_seed(0))
    assert (sig >= 0.002 * (1 - 1e-6)).all() and (sig <= 80.0 * (1 + 1e-6)).all()


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_agent_edm_loss_matches_jax(edm, mode):
    """An EDM agent's DSM term under the EMA shadow (``ema_loss``, the EDM
    branch of ``_gf_loss``) with JAX's draws: the score agent through its
    decoder head, the energy agent through D = x + sigma^2 grad E.
    rtol 1e-4."""
    if mode == "score":
        jag, tag = edm["jag"], edm["tag"]
    else:
        jag = jax_agent(Config(num_points=N_POINTS, sde_mode="edm"), "energy", seed=4)
        tag = port_agent(TorchConfig(num_points=N_POINTS, sde_mode="edm"), "energy", jag,
                         use_ema=True)
    rng = np.random.default_rng(12)
    batch = {"zero_mean_pts": _cloud(B, 12),
             "zero_mean_gt_pose": rng.normal(size=(B, 9)).astype(np.float32)}
    key = jax.random.PRNGKey(13)
    repeat = jag.cfg.repeat_num
    want = float(jag.ema_loss(_jb(batch), key))
    got = float(tag.ema_loss(_tb(batch), noise=_edm_draws(key, repeat, B)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# the agent's sample, get_energy and likelihood
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["pc", "edm", "edm_agent_ode"])
def test_agent_sample_matches_jax(ve, edm, case):
    """``PoseAgent.sample`` with K hypotheses a cloud, 5 steps, T0 = 0.55
    and the trajectory: PC under VE (JAX's per-step draws injected), EDM
    (JAX's latents injected) and Heun ``ode`` on the EDM agent (T0 mapped
    onto the sigma ladder, prior pinned); 1e-4 scaled.  The JAX agent jits
    T0 as a traced argument, and for ``edm`` that makes another program
    (the ladder computed on the device) than the one its pipeline runs,
    with T0 a Python float: the port is held to 1e-4 against the latter
    (the agent's ``_sample_impl`` jitted with T0 closed over) and to 1e-3
    against the former; both gaps are printed."""
    agents = ve if case == "pc" else edm
    jag, tag = agents["jag"], agents["tag"]
    sampler = "ode" if case == "edm_agent_ode" else case
    noise = np.random.default_rng(14).normal(size=(ROWS, 9)).astype(np.float32)
    pin_jax_prior(jag, noise)
    pin_port_prior(tag, noise)
    batch = _batch(15)
    key = jax.random.PRNGKey(16)
    jproc, jres = jag.sample(_jb(batch), key, repeat_num=K, sampler=sampler, num_steps=5,
                             T0=0.55, return_process=True)
    kw = {}
    if case == "pc":
        kw["noise"] = _pc_draws(key, 5, (ROWS, 9))
    elif case == "edm":
        kw["latents"] = t_np(np.asarray(jax.random.normal(jax.random.split(key)[0], (ROWS, 9))))
    tproc, tres = tag.sample(_tb(batch), repeat_num=K, sampler=sampler, num_steps=5, T0=0.55,
                             return_process=True, **kw)
    assert tres.shape == (B, K, 9) and tproc.shape == (B, K, 5, 9)
    tol = CHAIN_TOL
    if case == "edm":
        concrete = jax.jit(lambda st, b, k: jag._sample_impl(
            st, b, k, repeat_num=K, sampler="edm", num_steps=5, T0=0.55, return_process=True))
        cproc, cres = concrete(jag.state, _jb(batch), key)
        gap = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))  # noqa: E731
                                        / (1 + np.abs(np.asarray(b)))))
        print(f"EDM, scaled: port vs JAX concrete T0 {gap(tres.numpy(), cres):.3e}; "
              f"port vs JAX traced T0 {gap(tres.numpy(), jres):.3e}; "
              f"JAX traced vs concrete {gap(jres, cres):.3e}")
        _close(tres, cres, what="poses against JAX's concrete-T0 program")
        _close(tproc, cproc, what="trajectory against JAX's concrete-T0 program")
        tol = 1e-3
    _close(tres, jres, tol, what="poses")
    _close(tproc, jproc, tol, what="trajectory")


@pytest.mark.parametrize("mode", ["ve", "edm"])
def test_agent_get_energy_at_random_t_matches_jax(mode):
    """``get_energy`` without T: t = t_int / 1e5 per cloud with JAX's t_int
    draw injected, under VE and under EDM (where the energy divides by
    sigma = t); energies rtol 1e-5, atol 1e-3 beside values up to ~1e4."""
    jag = jax_agent(Config(num_points=N_POINTS, sde_mode=mode), "energy", seed=17)
    tag = port_agent(TorchConfig(num_points=N_POINTS, sde_mode=mode), "energy", jag,
                     use_ema=False)
    batch = _batch(18)
    poses = np.random.default_rng(19).normal(size=(B, K, 9)).astype(np.float32)
    key = jax.random.PRNGKey(20)
    want = np.asarray(jag.get_energy(_jb(batch), jnp.asarray(poses), key=key))
    t_int = t_np(np.asarray(jax.random.randint(key, (B, 1), 1, 10)))
    got = tag.get_energy(_tb(batch), t_np(poses), t_int=t_int)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    assert not np.allclose(want, np.asarray(jag.get_energy(_jb(batch), jnp.asarray(poses),
                                                           T=1e-5)))
    drawn = tag.get_energy(_tb(batch), t_np(poses), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (B, K, 2) and torch.isfinite(drawn).all()


def test_agent_likelihood_matches_jax(ve):
    """``PoseAgent.likelihood`` (EMA shadow, exact divergence), 6 steps."""
    jag, tag = ve["jag"], ve["tag"]
    batch = _batch(21)
    poses = np.random.default_rng(22).normal(size=(B, 9)).astype(np.float32)
    jz, jbits = jag.likelihood(_jb(batch), jnp.asarray(poses), jax.random.PRNGKey(0),
                               num_steps=STEPS)
    tz, tbits = tag.likelihood(_tb(batch), t_np(poses), num_steps=STEPS)
    _close(tz, jz, what="latent")
    _close(tbits, jbits, what="bits")


# ---------------------------------------------------------------------------
# the serving pipeline under PC and under EDM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["pc", "edm"])
def test_pipeline_matches_jax(case):
    """``InferencePipeline`` under ``sampler_mode=("pc",)`` (VE) and under
    ``sde_mode="edm"`` with the ``edm`` sampler, 4 steps, against the JAX
    pipeline: same weights, prior rows pinned, JAX's draws for the one
    chunk's key injected into the port's score agent.  Under EDM the
    energy head divides by sigma = t = 1e-5 at ranking time, so an energy
    (~1e4 here) moves by ~1e5 per unit of pose, and the energies of
    hypotheses 1e-5 apart are held to 1e-2 scaled; on the same poses the
    EDM energy head agrees to 1e-5
    (``test_agent_get_energy_at_random_t_matches_jax[edm]``)."""
    kw = dict(num_points=N_POINTS, batch_size=B, eval_repeat_num=K, sampling_steps=4,
              T0=0.55, sampler_mode=(case,))
    if case == "edm":
        kw["sde_mode"] = "edm"
    jp = JaxPipeline(Config(**kw))
    derandomize_agent(jp.score_agent, 1)
    derandomize_agent(jp.energy_agent, 2)
    noise = np.random.default_rng(23).normal(size=(ROWS, 9)).astype(np.float32)
    pin_jax_prior(jp.score_agent, noise)
    tp = InferencePipeline(TorchConfig(**kw), device="cpu")
    ss, es = jp.score_agent.state, jp.energy_agent.state
    tp.score_agent.load_jax(jax.device_get(ss.ema.shadow), jax.device_get(ss.batch_stats))
    tp.energy_agent.load_jax(jax.device_get(es.params), jax.device_get(es.batch_stats))
    pin_port_prior(tp.score_agent, noise)
    chunk_key = jax.random.split(jax.random.PRNGKey(0))[1]  # JaxPipeline.predict's first chunk
    if case == "pc":
        draws = {"noise": _pc_draws(chunk_key, 4, (ROWS, 9))}
    else:
        draws = {"latents": t_np(np.asarray(
            jax.random.normal(jax.random.split(chunk_key)[0], (ROWS, 9))))}
    tp.score_agent.sample = functools.partial(tp.score_agent.sample, **draws)
    pts = (_cloud(B, 24) + np.random.default_rng(25).normal(size=(B, 1, 3))).astype(np.float32)
    want = jp.predict(pts, key=jax.random.PRNGKey(0))
    got = tp.predict(pts)
    for k in ("best_pose", "sorted_hypotheses"):
        _close(got[k], want[k], what=k)
    _close(got["energy"], want["energy"], 1e-2 if case == "edm" else CHAIN_TOL, what="energy")
    q, wq = got["pred_pose"][:, :4], want["pred_pose"][:, :4]
    sign = np.sign(np.sum(q * wq, axis=1, keepdims=True))
    _close(q * sign, wq, what="pooled quaternion")
    _close(got["pred_pose"][:, 4:], want["pred_pose"][:, 4:], what="pooled translation")
