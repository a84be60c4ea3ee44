"""The port's training steps and optimizer against the JAX package's, on the CPU.

Both sides start from the same derandomised JAX state (non-zero heads, an
EMA shadow that differs from the live params, perturbed BatchNorm
statistics), carried into the port by ``from_jax_train_state``.  The JAX
side runs its own jitted steps (``train_step``, ``train_step_energy``,
``train_step_distill``, ``ema_loss``) with PRNG keys; the test derives the
same draws from those keys (the DSM t and z, the energy t) and hands them
to the port.  Batches are numpy arrays given to both.

Float32 conditioning: at these sizes the encoder's gradients are
ill-conditioned in float32.  The max-pools pick among near-equal values and
train-mode BatchNorm over few rows divides by small batch variances, so
each package's float32 encoder gradient lies 1-5% (of the tensor's largest
element) from a float64 evaluation of the same step (measured with the
port run in float64); the heads' gradients agree to ~1e-5.

Optimizer: the step trajectories therefore use SGD (momentum 0.9, weight
decay 1e-4, clip 1.0), whose update is lr times the gradient, so that
noise moves a parameter by ~lr * 1e-2 * |g|.  Adam divides each element by
its own gradient scale, so noise can change an element's update by a
sizeable fraction of lr (``tests/test_training_parity.py`` saw the same
against the reference).  Adam's math is held tightly on synthetic gradients
(``test_optimizer_matches_optax``), and the one composed Adam check is a
single step resumed from a JAX state.

Tolerances: losses rtol 1e-5.  Params, EMA shadow and BatchNorm statistics
rtol 1e-3 / atol 3e-5 after two or three steps: the float noise above,
carried through the updates, reaches ~1e-5 absolute (measured), while a
wrong learning rate, momentum, EMA decay or BatchNorm momentum moves them by
1e-4 to 1e-1.  A train-mode encoder pass itself differs by up to ~1e-3
relative: flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2,
which cancels digits where a channel's mean is large beside its spread,
while PyTorch's BatchNorm takes it in two passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import Config
from genpose_tpu.data.process import process_batch as jax_process_batch
from genpose_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from genpose_tpu.diffusion.losses import dsm_loss_repeated as jax_dsm_loss_repeated
from genpose_tpu.training.state import create_train_state as jax_create_train_state
from genpose_tpu.training.state import make_lr_schedule as jax_make_lr_schedule
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.state import create_train_state, make_lr_schedule
from genpose_tpu_torch.utils.weights import from_jax_train_state, from_jax_variables
from _torch_parity import dsm_noise as parity_dsm_noise
from _torch_parity import train_agent

N_PTS, BS, REPEAT, K = 128, 2, 2, 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STATE_TOL = dict(rtol=1e-3, atol=3e-5)
GRAD_TOL = 0.2  # per-leaf gradient, relative to its norm (test_step_gradients_match_jax)
COMMON = dict(num_points=N_PTS, batch_size=BS, repeat_num=REPEAT, warmup=2, lr=1e-3,
              optimizer="SGD")


def _cfgs(**kw):
    kw = {**COMMON, **kw}
    return Config(gather_fwd="exact", gather_grad="exact", **kw), TorchConfig(**kw)


def _batches(n, seed, ids=None, hv=None):
    """Processed numpy batches (the JAX package's process_batch, no augmentation)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = jax_synthetic_batch(rng, bs=BS, n_pts=N_PTS, n_model=256)
        if ids is not None:
            raw["cat_id"], raw["handle_visibility"] = np.asarray(ids, np.int32), \
                np.asarray(hv, np.int32)
        out.append({k: np.asarray(v) for k, v in jax_process_batch(raw).items()})
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def dsm_noise(key, sde_eps):
    return parity_dsm_noise(key, sde_eps, REPEAT, BS)


def _port(jagent, tcfg, mode, steps_per_epoch=1000):
    agent = PoseAgent(tcfg, mode, device="cpu", steps_per_epoch=steps_per_epoch)
    from_jax_train_state(jax.device_get(jagent.state), agent)
    return agent


def _assert_state(jagent, agent, what):
    st = jax.device_get(jagent.state)
    names = set(agent.params())
    want = from_jax_variables(st.params, st.batch_stats)
    got = agent.model.state_dict()
    for k, v in want.items():
        if "num_batches" in k:
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **STATE_TOL,
                                   err_msg=f"{what}: {k}")
    shadow = from_jax_variables(st.ema.shadow, {})
    for k in names:
        np.testing.assert_allclose(agent.state.ema.shadow[k].numpy(), shadow[k].numpy(),
                                   **STATE_TOL, err_msg=f"{what}: EMA shadow {k}")
    assert agent.state.step == int(st.step)
    assert agent.state.ema.num_updates == int(st.ema.num_updates)


# ---------------------------------------------------------------------------
# schedule and optimizer on synthetic gradients
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    for args in ((1e-3, 100, 0.98, 50, 1e-4), (1e-3, 3, 0.3, 4, 1e-4), (5e-4, 0, 1.0, 10, 1e-4)):
        jsched, tsched = jax_make_lr_schedule(*args), make_lr_schedule(*args)
        steps = np.arange(0, 400)
        want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
        got = np.array([tsched(int(s)) for s in steps], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert make_lr_schedule(1e-3, 100, 0.98, 1000)(0) == 0.0


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_optimizer_matches_optax(optimizer):
    """10 updates through clip -> Adam or SGD -> EMA on the same gradients as
    the JAX TrainState: the default schedule (lr 0 at step 0, warmup 3,
    4 steps per epoch, decay 0.3 down to the floor), gradients from
    exactly zero through eps-dominated to clip-triggering.  rtol 1e-6."""
    rng = np.random.RandomState(3)
    shapes = {"a": (4, 7), "b": (16,), "c": (3, 3, 5), "d": (2,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    steps = 10
    grads = []
    for _ in range(steps):
        g = {k: (rng.randn(*s) * 10.0 ** rng.randint(-9, 3)).astype(np.float32)
             for k, s in shapes.items()}
        g["d"] = np.zeros_like(g["d"])
        grads.append(g)
    kw = dict(base_lr=1e-3, warmup_steps=3, decay_per_epoch=0.3, steps_per_epoch=4,
              grad_clip=1.0, ema_rate=0.999, optimizer=optimizer)
    jstate = jax_create_train_state({"params": {k: jnp.asarray(v) for k, v in init.items()}},
                                    **kw)
    tstate = create_train_state(**kw)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    for n, g in enumerate(grads):
        jstate = jstate.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        tstate.apply_gradients(params, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {n} {k}")
            if n == 0:  # lr 0: the first update leaves the params as they are
                np.testing.assert_array_equal(params[k].numpy(), init[k])
    for k in shapes:
        np.testing.assert_allclose(tstate.ema.shadow[k].numpy(), np.asarray(jstate.ema.shadow[k]),
                                   rtol=1e-6, atol=1e-7)
    assert tstate.step == int(jstate.step) == tstate.ema.num_updates == steps
    # moments: atol 1e-8 beside values of ~1e-2; the clip divides by a global
    # norm that the two sides sum in another order (an ulp of the norm)
    moments = ("mu", "nu") if optimizer == "Adam" else ("trace",)
    jopt = jstate.opt_state[1][0] if optimizer == "Adam" else jstate.opt_state[1][1][0]
    for m in moments:
        for k in shapes:
            np.testing.assert_allclose(tstate.opt_state[m][k].numpy(),
                                       np.asarray(getattr(jopt, m)[k]), rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# composed steps against the JAX agent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def score_pair():
    jcfg, tcfg = _cfgs()
    js = train_agent(jcfg, "score", seed=1)
    return js, _port(js, tcfg, "score"), tcfg


def test_bn_running_stats_after_a_train_mode_pass(score_pair):
    """nn.BatchNorm1d(momentum=0.1) over channels-last rows in train mode
    equals TorchBatchNorm(momentum=0.9): batch statistics normalise, the
    running variance tracks the unbiased variance."""
    from genpose_tpu.models.posenet import GFObjectPose

    js, ts, _ = score_pair
    pts = _batches(1, seed=9)[0]["zero_mean_pts"]
    st = js.state
    jfeat, mutated = js.model.apply({"params": st.params, "batch_stats": st.batch_stats},
                                    jnp.asarray(pts), train=True, method=GFObjectPose.encode_pts,
                                    mutable=["batch_stats"])
    model = PoseAgent(ts.cfg, "score", device="cpu").model
    model.load_state_dict(ts.model.state_dict())
    model.train()
    with torch.no_grad():
        feat = model.encode_pts(torch.from_numpy(pts))
    # the variance formulas differ (module docstring): ~1e-3 relative here
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=2e-3, atol=1e-4)
    want = from_jax_variables(st.params, mutated["batch_stats"])
    got = model.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_score_train_steps_match_jax(score_pair):
    """Three score steps (lr 0, 5e-4, 1e-3 under warmup 2), then the EMA loss."""
    js, ts, _ = score_pair
    batches = _batches(2, seed=5)
    key = jax.random.PRNGKey(7)
    for n in range(3):
        key, k = jax.random.split(key)
        b = batches[n % 2]
        want = float(js.train_step(_j(b), k)["gf"])
        got = float(ts.train_step(_t(b), noise=dsm_noise(k, js.sde.eps))["gf"])
        np.testing.assert_allclose(got, want, **LOSS_TOL, err_msg=f"step {n}")
    _assert_state(js, ts, "score after 3 steps")
    w = np.asarray(js.state.params["head"]["trunk"]["t_fourier"]["W"])
    np.testing.assert_array_equal(ts.model.head.trunk.t_fourier.W.numpy(), w)
    key, k = jax.random.split(key)
    want = float(js.ema_loss(_j(batches[0]), k))
    got = float(ts.ema_loss(_t(batches[0]), noise=dsm_noise(k, js.sde.eps)))
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_energy_train_steps_match_jax():
    """Three energy-with-ranking steps with K=3 candidates: a bowl and a mug
    without a visible handle (both ranked by the y-axis angle), candidates'
    translations around the cloud center, t = randint(1, 10) / 1e5."""
    jcfg, tcfg = _cfgs()
    je = train_agent(jcfg, "energy", seed=2)
    te = _port(je, tcfg, "energy")
    batches = _batches(2, seed=6, ids=[1, 5], hv=[1, 0])
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(9)
    for n in range(3):
        b = batches[n % 2]
        cands = rng.normal(size=(BS, K, 9)).astype(np.float32) * 0.3
        cands[..., -3:] = b["gt_pose"][:, None, -3:] + 0.05 * cands[..., -3:]
        key, k = jax.random.split(key)
        k_dsm, k_t = jax.random.split(k)
        t_int = torch.from_numpy(np.asarray(jax.random.randint(k_t, (BS, 1), 1, 10)))
        want = je.train_step_energy(_j(b), jnp.asarray(cands), k)
        got = te.train_step_energy(_t(b), torch.from_numpy(cands),
                                   noise=dsm_noise(k_dsm, je.sde.eps), t_int=t_int)
        for name in ("gf", "ranking"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), **LOSS_TOL,
                                       err_msg=f"step {n} {name}")
    _assert_state(je, te, "energy after 3 steps")


def test_energy_dsm_reaches_the_energy_head():
    """The energy's score is dE/dpose, so its DSM gradient is a double
    backward: with the graph kept it is non-zero on the head and equals
    jax.grad of the same loss; without it the head gets nothing."""
    from genpose_tpu.models.posenet import GFObjectPose

    jcfg, tcfg = _cfgs()
    je = train_agent(jcfg, "energy", seed=4)
    te = _port(je, tcfg, "energy")
    b = _batches(1, seed=10)[0]
    key = jax.random.PRNGKey(11)
    st = je.state

    def jloss(params):
        feat = je.model.apply({"params": params, "batch_stats": st.batch_stats},
                              jnp.asarray(b["zero_mean_pts"]), train=False,
                              method=GFObjectPose.encode_pts)
        score_fn = je._head_score_fn(params, st.batch_stats, feat)
        return jax_dsm_loss_repeated(score_fn, key, jnp.asarray(b["zero_mean_gt_pose"]),
                                     je.sde, REPEAT)

    want = np.asarray(jax.grad(jloss)(st.params)["head"]["trunk"]["tails"]["out_kernel"])
    head = te.model.head.trunk.tails.out_kernel
    noise = dsm_noise(key, je.sde.eps)
    for create_graph in (True, False):
        head.requires_grad_(True)
        try:
            with torch.enable_grad():
                feat = te._encode(torch.from_numpy(b["zero_mean_pts"]), train=False)
                score_fn = te._head_score_fn(feat, tile=REPEAT, create_graph=create_graph)
                from genpose_tpu_torch.diffusion.losses import dsm_loss_repeated

                loss = dsm_loss_repeated(score_fn, torch.from_numpy(b["zero_mean_gt_pose"]),
                                         te.sde, REPEAT, noise=noise)
                g = (torch.autograd.grad(loss, head, allow_unused=True)[0]
                     if loss.requires_grad else None)
        finally:
            head.requires_grad_(False)
        if create_graph:
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-3, atol=1e-5)
        else:
            assert g is None or not g.any()


class _GradsOf:
    """Stands in for the JAX TrainState in a step's impl: the step hands its
    gradients to ``apply_gradients``, which returns them."""

    def __init__(self, params, batch_stats):
        self.params, self.batch_stats = params, batch_stats

    def apply_gradients(self, grads, new_batch_stats=None):
        return grads


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_step_gradients_match_jax(mode):
    """The gradient each package's train step hands to its optimizer (score
    DSM; energy DSM + ranking with K=3 candidates), leaf by leaf: the norm of
    the difference over the norm of the JAX gradient, at most GRAD_TOL for
    every leaf, the encoder's included.  The encoder's float32 noise (module
    docstring) leaves the worst leaf at 0.050 (score) and 0.033 (energy)
    (measured); a zeroed or sign-flipped gradient is at 1 or 2.  A leaf whose
    gradient is zero but for rounding (the last BatchNorm bias of stage 2:
    the max-pool passes its shift on, and stage 3's train-mode BatchNorm
    removes it; 2e-9 of the largest leaf's norm) is measured against 1e-4 of
    the largest leaf's norm instead."""
    jcfg, tcfg = _cfgs()
    ja = train_agent(jcfg, mode, seed=19 if mode == "score" else 20)
    ta = _port(ja, tcfg, mode)
    b = _batches(1, seed=21, ids=[1, 5], hv=[1, 0])[0]
    key = jax.random.PRNGKey(22)
    st = jax.device_get(ja.state)
    grabbed = {}
    ta.state.apply_gradients = lambda params, grads: grabbed.update(grads)
    if mode == "score":
        want = jax.jit(lambda p, s, bt, k: ja._train_step_score_impl(_GradsOf(p, s), bt, k)[0])(
            st.params, st.batch_stats, _j(b), key)
        ta.train_step(_t(b), noise=dsm_noise(key, ja.sde.eps))
    else:
        cands = np.random.default_rng(23).normal(size=(BS, K, 9)).astype(np.float32) * 0.3
        cands[..., -3:] = b["gt_pose"][:, None, -3:] + 0.05 * cands[..., -3:]
        want = jax.jit(lambda p, s, bt, c, k: ja._train_step_energy_impl(
            _GradsOf(p, s), bt, c, k)[0])(st.params, st.batch_stats, _j(b), jnp.asarray(cands),
                                          key)
        k_dsm, k_t = jax.random.split(key)
        t_int = torch.from_numpy(np.asarray(jax.random.randint(k_t, (BS, 1), 1, 10)))
        ta.train_step_energy(_t(b), torch.from_numpy(cands),
                             noise=dsm_noise(k_dsm, ja.sde.eps), t_int=t_int)
    want = from_jax_variables(jax.device_get(want), {})
    assert set(grabbed) == set(ta.params())
    floor = 1e-4 * max(float(g.norm()) for g in want.values())
    rel = {k: float((g - want[k]).norm()) / max(float(want[k].norm()), floor)
           for k, g in grabbed.items()}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_TOL, f"{worst}: {rel[worst]}"
    assert sum(k.startswith("encoder.") and float(want[k].norm()) > floor for k in rel) > 50


def test_distill_steps_match_jax():
    """Two distillation steps: an energy student against a score teacher's
    EMA shadow."""
    jcfg, tcfg = _cfgs()
    jt = train_agent(jcfg, "score", seed=12)
    jst = train_agent(jcfg, "energy", seed=13)
    tt, tst = _port(jt, tcfg, "score"), _port(jst, tcfg, "energy")
    batches = _batches(2, seed=14)
    key = jax.random.PRNGKey(15)
    for n in range(2):
        key, k = jax.random.split(key)
        want = float(jst.train_step_distill(jt, _j(batches[n]), k)["gf"])
        got = float(tst.train_step_distill(tt, _t(batches[n]),
                                           noise=dsm_noise(k, jst.sde.eps))["gf"])
        np.testing.assert_allclose(got, want, **LOSS_TOL, err_msg=f"step {n}")
    _assert_state(jst, tst, "distilled student after 2 steps")


def test_resume_from_a_jax_state_mid_trajectory():
    """Adam, the released optimizer: two steps in JAX, then the port takes
    the JAX state (params, BN statistics, EMA shadow and count, step, Adam
    moments) and both run the third step.

    The third step's loss depends only on the state carried over: rtol 1e-5.
    The head, whose gradients agree to ~1e-5: moments atol 1e-3 of the
    tensor's largest, params atol 5e-2 lr (measured 1.1e-2 lr at one of
    196,608 elements).  The encoder, whose float32
    gradients carry the 1-5% noise of the module docstring: moments atol 5%
    of the model's largest moment (moments not carried over would be off by
    >50%), params atol 2.5 lr only, as Adam can turn gradient noise at an
    element with a small gradient into a step of a different sign
    (measured: 1.3 lr at one of 64 BatchNorm biases)."""
    jcfg, tcfg = _cfgs(optimizer="Adam")
    js = train_agent(jcfg, "score", seed=16)
    batches = _batches(3, seed=17)
    keys = jax.random.split(jax.random.PRNGKey(18), 3)
    for n in range(2):
        js.train_step(_j(batches[n]), keys[n])
    ts = _port(js, tcfg, "score")
    assert ts.state.step == 2 and ts.state.ema.num_updates == 2
    before = {k: p.detach().clone() for k, p in ts.params().items()}
    want = float(js.train_step(_j(batches[2]), keys[2])["gf"])
    got = float(ts.train_step(_t(batches[2]), noise=dsm_noise(keys[2], js.sde.eps))["gf"])
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    st = jax.device_get(js.state)
    assert ts.state.step == int(st.step) == 3
    adam = st.opt_state[1][0]
    lr = ts.state.schedule(2)
    params = from_jax_variables(st.params, {})
    moments = {m: from_jax_variables(getattr(adam, m), {}) for m in ("mu", "nu")}
    top = {m: max(float(v.abs().max()) for v in sd.values()) for m, sd in moments.items()}
    moved = 0
    for k, p in ts.params().items():
        head = k.startswith("head.")
        for m, sd in moments.items():
            want_m = sd[k].numpy()
            tol = 1e-3 * np.abs(want_m).max() if head else 0.05 * top[m]
            np.testing.assert_allclose(ts.state.opt_state[m][k].numpy(), want_m, rtol=0,
                                       atol=tol, err_msg=f"{m} {k}")
        np.testing.assert_allclose(p.detach().numpy(), params[k].numpy(), rtol=0,
                                   atol=5e-2 * lr if head else 2.5 * lr, err_msg=k)
        moved += int((p.detach() != before[k]).sum())
    assert moved > 0.9 * sum(p.numel() for p in before.values())


def test_load_jax_keeps_the_shadow_apart(score_pair):
    """load_jax: without a shadow, sampling reads the live params (so a later
    perturbation reaches it); with one, sampling reads the shadow and the
    energy path the live params."""
    from genpose_tpu_torch.utils.weights import perturb_

    js, _, tcfg = score_pair
    st = jax.device_get(js.state)
    agent = PoseAgent(tcfg, "score", device="cpu").load_jax(st.params, st.batch_stats)
    assert agent.state.ema.shadow is None
    with agent.ema_weights():
        before = agent.model.head.trunk.t_dense.weight.clone()
    perturb_(agent.model, seed=3)
    with agent.ema_weights():
        assert not torch.equal(agent.model.head.trunk.t_dense.weight, before)
    agent.load_jax(st.params, st.batch_stats, ema_shadow=st.ema.shadow)
    live = agent.model.head.trunk.t_dense.weight.clone()
    want = np.asarray(st.ema.shadow["head"]["trunk"]["t_dense"]["kernel"]).T
    with agent.ema_weights():
        np.testing.assert_array_equal(agent.model.head.trunk.t_dense.weight.numpy(), want)
    assert torch.equal(agent.model.head.trunk.t_dense.weight, live)
    bad = jax.tree_util.tree_map(lambda x: x, st.ema.shadow)
    bad["head"]["trunk"]["t_fourier"]["W"] = bad["head"]["trunk"]["t_fourier"]["W"] + 1.0
    with pytest.raises(ValueError, match="buffer"):
        agent.load_jax(st.params, st.batch_stats, ema_shadow=bad)
