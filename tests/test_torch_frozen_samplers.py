"""Every sampler through a frozen genpose_tpu_torch agent, and the port's
runners under the PC and EDM samplers against the JAX runners.

On the CPU the frozen programs run the same static-buffer code as on a card,
without the capture:

- frozen = eager bit for bit (``torch.equal``), from the same generator
  state, for PC under VE (the full ladder; T0 with ``init_x``, the per-step
  draws drawn and injected), PC under VP, EDM (``latents`` drawn and
  injected), the trajectories of ``ode``, ``pc`` and ``edm``, a bfloat16
  arm, a chunk padded to ``batch_size`` (PC's corrector step is a mean over
  all rows), and the likelihood; the generator's state afterwards equals
  eager's, and ``frozen.dispatches`` counts each frozen call;
- ``evaluation_single`` stages 2-3 with both agents frozen (as its ``main``
  runs them) and ``main_tracking`` (which freezes them) under
  ``--sampler_mode pc`` and under ``--sde_mode edm --sampler_mode edm``
  against the JAX runners: the same weights, the score agents' priors
  pinned to the same rows (``tests/_torch_parity.py``) and the draws JAX
  makes from each chunk's or frame's key injected into the port's frozen
  agent (PC's per-step noise, EDM's unit latents).  Under EDM the JAX
  evaluation runner's stage 2 runs op by op (``jax.disable_jit``): at these
  weights and clouds XLA's compiled EDM sampler lies up to ~9e-4 from JAX's
  own op-by-op evaluation of the same function (the 4-step ladder divides
  by sigma down to 0.002), and the port's agrees with the op-by-op one to
  ~2e-7 (its jitted T0 is traced, ~5e-4 further off).  RTs, energies and
  pooled poses within rtol = atol = 1e-4, the tolerance of
  ``tests/test_torch_eval_single.py`` and ``tests/test_torch_tracking.py``;
  under EDM the energies at t = 1e-5 within 1e-2 scaled by magnitude, since
  the EDM energy head divides by sigma = 1e-5 and moves by ~1e5 per unit of
  pose (``tests/test_torch_sde_samplers.py::test_pipeline_matches_jax``);
  the mAP tables from each side's own results and the tracking metrics'
  5deg5cm accuracies are identical, the mean errors within 1e-4.

The ``cuda`` case replays the graphs on a card and skips elsewhere.  JAX is
imported only inside the cases that compare with it, so the card's machine
runs the ``cuda`` case without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_frozen_samplers.py``.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.runners.evaluation_single import pad_rows
from genpose_tpu_torch.training import frozen
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.state import EMA
from genpose_tpu_torch.utils.weights import perturb_

B, K, N_POINTS, STEPS = 2, 3, 64, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (several tier-1
    workers share the machine; the samplers' many small ops slow down
    severely under a thread per core in each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agent(seed=1, device="cpu", **cfg):
    """A score agent with non-zero heads and an EMA shadow apart from the
    live parameters (a frozen copy of the wrong set disagrees)."""
    kw = dict(num_points=N_POINTS, batch_size=B, eval_repeat_num=K, sampling_steps=STEPS)
    agent = PoseAgent(Config(**dict(kw, **cfg)), "score", device=device)
    perturb_(agent.model, seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    agent.state.ema = EMA(0.999, {k: p + 0.01 * torch.randn(p.shape, generator=g).to(p.device)
                                  for k, p in agent.params().items()})
    return agent


def _batch(n, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy((rng.normal(size=(n, N_POINTS, 3)) * 0.1).astype(np.float32))
    pts = pts.to(device)
    center = pts.mean(dim=1) + 0.5
    return {"zero_mean_pts": pts - pts.mean(dim=1, keepdim=True), "pts_center": center}


def _draws(seed, shape, steps):
    g = torch.Generator().manual_seed(seed)
    return {"noise": (torch.randn((steps, *shape), generator=g),
                      torch.randn((steps, *shape), generator=g)),
            "latents": torch.randn(shape, generator=g)}


# arm -> (agent config, sample kwargs, injected draws)
ARMS = {
    "pc_ve_full_ladder": ({}, dict(sampler="pc", T0=None), None),
    "pc_ve_T0_init_x": ({}, dict(sampler="pc", T0=0.55, init=True), None),
    "pc_ve_T0_init_x_injected": ({}, dict(sampler="pc", T0=0.55, init=True), "noise"),
    "pc_vp": (dict(sde_mode="vp"), dict(sampler="pc", T0=0.55), None),
    "edm": (dict(sde_mode="edm"), dict(sampler="edm", T0=0.55), None),
    "edm_injected_init_x": (dict(sde_mode="edm"), dict(sampler="edm", T0=0.55, init=True),
                            "latents"),
    "ode_trajectory": ({}, dict(sampler="ode", T0=0.55, return_process=True), None),
    "pc_trajectory": ({}, dict(sampler="pc", T0=0.55, return_process=True), None),
    "edm_trajectory": (dict(sde_mode="edm"), dict(sampler="edm", T0=None, return_process=True),
                       None),
    "pc_bf16": (dict(compute_dtype="bfloat16"), dict(sampler="pc", T0=0.55), None),
    "pc_padded": ({}, dict(sampler="pc", T0=0.55, padded=True), None),
}


def _call(agent, arm, batch, seed=0):
    """One ``sample`` of ``arm`` from a fresh generator: (its outputs as a
    tuple, the generator's state after it)."""
    _, kw, inject = ARMS[arm]
    kw = dict(kw)
    bs = batch["zero_mean_pts"].shape[0]
    init = (torch.randn(bs, 9, generator=torch.Generator().manual_seed(3))
            if kw.pop("init", False) else None)
    kw.pop("padded", None)
    extra = {}
    if inject:
        extra[inject] = _draws(5, (bs * K, 9), STEPS)[inject]
    gen = torch.Generator().manual_seed(seed)
    out = agent.sample(batch, generator=gen, repeat_num=K, num_steps=STEPS, init_x=init,
                       **kw, **extra)
    return (out if isinstance(out, tuple) else (out,)), gen.get_state()


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_frozen_sample_equals_eager(arm):
    cfg, kw, _ = ARMS[arm]
    agent = _agent(**cfg)
    batch = _batch(B, 0)
    if kw.get("padded"):  # one instance padded to batch_size, as the runners pad a chunk
        batch = {k: pad_rows(v[:1], B) for k, v in _batch(1, 0).items()}
    eager, eager_gen = _call(agent, arm, batch)
    agent.freeze()
    n0 = frozen.dispatches
    got, got_gen = _call(agent, arm, batch)
    again, _ = _call(agent, arm, batch)  # the captured program, the new inputs copied in
    assert frozen.dispatches == n0 + 2 and len(agent.frozen_programs().programs) == 1
    assert len(got) == len(eager) == (2 if kw.get("return_process") else 1)
    for g, a, e in zip(got, again, eager):
        assert torch.equal(g, e) and torch.equal(a, e) and torch.isfinite(g).all()
    assert torch.equal(got_gen, eager_gen)
    assert got[-1].shape == (B, K, 9)
    if kw.get("return_process"):
        assert got[0].shape == (B, K, STEPS, 9)
    if kw.get("padded"):  # the padded row is part of the real row's result
        alone, _ = _call(_agent(**cfg), arm, _batch(1, 0))
        assert not torch.equal(alone[0][0], got[0][0])


def test_frozen_injected_draws_replace_the_generator():
    """Injected PC noise: the frozen call consumes only the prior from the
    generator, as eager does, and other draws give other poses."""
    agent, batch = _agent(), _batch(B, 0)
    shape = (B * K, 9)
    kw = dict(repeat_num=K, sampler="pc", num_steps=STEPS, T0=0.55)
    eager = agent.sample(batch, torch.Generator().manual_seed(0), noise=_draws(5, shape, STEPS)[
        "noise"], **kw)
    agent.freeze()
    gen = torch.Generator().manual_seed(0)
    got = agent.sample(batch, gen, noise=_draws(5, shape, STEPS)["noise"], **kw)
    other = agent.sample(batch, torch.Generator().manual_seed(0),
                         noise=_draws(6, shape, STEPS)["noise"], **kw)
    ref = torch.Generator().manual_seed(0)
    agent.sde.prior((B * K, 9), T=0.55, generator=ref)
    assert torch.equal(got, eager) and not torch.equal(other, got)
    assert torch.equal(gen.get_state(), ref.get_state())


def test_frozen_likelihood_equals_eager():
    agent, batch = _agent(), _batch(B, 1)
    poses = torch.randn(B, 9, generator=torch.Generator().manual_seed(2)) * 0.3
    eager = agent.likelihood(batch, poses, num_steps=STEPS)
    agent.freeze()
    n0 = frozen.dispatches
    got = agent.likelihood(batch, poses, num_steps=STEPS)
    assert frozen.dispatches == n0 + 1
    for g, e in zip(got, eager):
        assert torch.equal(g, e) and torch.isfinite(g).all()


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager_for_every_sampler():
    """On a card: the replayed graphs of PC, EDM, the trajectories and the
    frozen likelihood equal eager bit for bit, also on a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    dev = torch.device("cuda")
    for arm in ("pc_ve_T0_init_x", "edm", "ode_trajectory", "pc_trajectory", "pc_bf16"):
        cfg = ARMS[arm][0]
        agent, batch = _agent(device=dev, **cfg), _batch(B, 0, dev)
        gen = torch.Generator(device=dev)
        kw = {k: v for k, v in ARMS[arm][1].items() if k != "init"}
        init = torch.randn(B, 9, device=dev) if ARMS[arm][1].get("init") else None

        def call():
            gen.manual_seed(0)
            out = agent.sample(batch, gen, repeat_num=K, num_steps=STEPS, init_x=init, **kw)
            return out if isinstance(out, tuple) else (out,)

        eager = call()
        agent.freeze()
        for _ in range(2):  # the capture's call, then a replay
            assert all(torch.equal(g, e) for g, e in zip(call(), eager)), arm
        assert all(s.graph is not None for p in agent.frozen_programs().programs.values()
                   for s in p.segments)
    agent = _agent(device=dev)
    poses = torch.randn(B, 9, device=dev) * 0.3
    eager = agent.likelihood(_batch(B, 1, dev), poses, num_steps=STEPS)
    got = agent.freeze().likelihood(_batch(B, 1, dev), poses, num_steps=STEPS)
    assert all(torch.equal(g, e) for g, e in zip(got, eager))


# ---------------------------------------------------------------------------
# the runners under PC and EDM against the JAX runners
# ---------------------------------------------------------------------------

RUNNER_CASES = {"pc": ["--sampler_mode", "pc"],
                "edm": ["--sde_mode", "edm", "--sampler_mode", "edm"]}
TOL = dict(rtol=1e-4, atol=1e-4)
EDM_ENERGY_TOL = 1e-2  # |port - jax| / (1 + |jax|), see the module docstring


def _scaled_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    diff = np.max(np.abs(got - want) / (1.0 + np.abs(want)), initial=0.0)
    assert diff <= tol, f"{what}: max scaled diff {diff} > {tol}"


def _jax_draws(case, key, rows, steps):
    """The draws JAX's sampler makes from a chunk's or frame's key, as the
    port's ``noise`` (PC) or ``latents`` (EDM)."""
    import jax

    from test_torch_sde_samplers import _pc_draws

    if case == "pc":
        return {"noise": _pc_draws(key, steps, (rows, 9))}
    return {"latents": torch.from_numpy(np.array(
        jax.random.normal(jax.random.split(key)[0], (rows, 9))))}


def _inject(agent, case, keys, steps):
    """Hand the frozen port agent the draws of the JAX key of each call,
    in call order (``keys()`` yields them)."""
    orig, it = agent.sample, keys()

    def sample(batch, *args, **kwargs):
        rows = batch["zero_mean_pts"].shape[0] * kwargs["repeat_num"]
        return orig(batch, *args, **kwargs, **_jax_draws(case, next(it), rows, steps))

    agent.sample = sample


def _pinned_pairs(jcfg, tcfg, seeds, noise):
    from _torch_parity import jax_agent, pin_jax_prior, pin_port_prior, port_agent

    js, je = jax_agent(jcfg, "score", seed=seeds[0]), jax_agent(jcfg, "energy", seed=seeds[1])
    ts, te = port_agent(tcfg, "score", js, use_ema=True), port_agent(tcfg, "energy", je, False)
    pin_jax_prior(js, noise)
    pin_port_prior(ts, noise)
    return js, je, ts, te


EVAL_FLAGS = ["--test_source", "real_test", "--num_points", "128", "--eval_repeat_num", "3",
              "--sampling_steps", "4", "--T0", "0.55", "--batch_size", "4",
              "--pooling_mode", "average", "--eval_ratios", "0.6"]
EVAL_NOISE = np.random.default_rng(0).normal(size=(4 * 3, 9)).astype(np.float32)


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """Two Real/test scenes and the port's stage-1 cache, read by both runners."""
    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.data.synthetic import (make_synthetic_mrcnn_results,
                                                  make_synthetic_nocs_dir)
    from genpose_tpu_torch.runners import evaluation_single as tev

    root = tmp_path_factory.mktemp("eval_pc_edm")
    nocs = make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1, n_real_scenes=2,
                                   seed=5)
    make_synthetic_mrcnn_results(nocs, str(root), "real_test")
    seg = str(root / "seg.pkl")
    tev.detect_mrcnn_results(get_config(["--data_path", nocs, "--result_dir", str(root)]
                                        + EVAL_FLAGS), seg)
    return root, nocs, seg


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_evaluation_single_frozen_matches_jax(eval_tree, case, monkeypatch):
    """Stages 2-3 with both agents frozen on both sides (each ``main``
    freezes them), then stage 4 of each side's own results."""
    import jax

    from genpose_tpu.config import get_config as jax_get_config
    from genpose_tpu.runners import evaluation_single as jev
    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.runners import evaluation_single as tev

    root, nocs, seg = eval_tree
    argv = ["--data_path", nocs, "--result_dir", str(root)] + EVAL_FLAGS + RUNNER_CASES[case]
    jcfg, tcfg = jax_get_config(argv), get_config(argv)
    js, je, ts, te = _pinned_pairs(jcfg, tcfg, (1, 2), EVAL_NOISE)
    for agent in (js, je, ts, te):
        agent.freeze()
    def chunk_keys():  # JAX inference_pose: key, k_s = split(key) per chunk
        key = jax.random.PRNGKey(0)
        while True:
            key, k_s = jax.random.split(key)
            yield k_s

    _inject(ts, case, chunk_keys, tcfg.sampling_steps)
    dirs = {side: str(root / case / side) for side in ("jax", "port")}
    n0 = frozen.dispatches
    # under EDM the JAX stage 2 runs op by op: see the module docstring
    with jax.disable_jit(case == "edm"):
        jev.inference_pose(jcfg, js, seg, dirs["jax"], key=jax.random.PRNGKey(0))
    tev.inference_pose(tcfg, ts, seg, dirs["port"])
    jev.inference_energy(jcfg, je, dirs["jax"])
    tev.inference_energy(tcfg, te, dirs["port"])

    def load(side, name):
        with open(os.path.join(dirs[side], name), "rb") as f:
            return pickle.load(f)

    chunks = sum(-(-len(d["pred_pose"]) // 4) for d in load("port", "cls_data.pkl").values())
    assert chunks >= 2 and frozen.dispatches == n0 + 2 * chunks  # stage 2 + stage 3
    for name in ("results_wo_energy.pkl", "results_with_energy.pkl"):
        want, got = load("jax", name), load("port", name)
        assert len(want) == len(got)
        for (path, ej), et in zip(want.items(), got.values()):
            inst = et["valid_inst"]
            rts = et["result"]["multi_hypothesis_pred_RTs"][inst]
            assert rts.shape[1] == 3 and not np.allclose(rts, np.eye(4))
            np.testing.assert_allclose(rts, ej["result"]["multi_hypothesis_pred_RTs"][inst],
                                       err_msg=f"{name} {path}", **TOL)
            if name == "results_with_energy.pkl":
                e, ew = et["result"]["energy"][inst], ej["result"]["energy"][inst]
                if case == "edm":
                    _scaled_close(e, ew, EDM_ENERGY_TOL, f"energy {path}")
                else:
                    np.testing.assert_allclose(e, ew, err_msg=f"energy {path}", **TOL)
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "plot_mAP", lambda *args, **kwargs: None)
    jev.evaluate(jcfg, dirs["jax"])
    tev.evaluate(tcfg, dirs["port"])
    tables = [pickle.load(open(os.path.join(d, "results", "average", "energy_ranker",
                                            "mAP_Acc.pkl"), "rb")) for d in dirs.values()]
    assert sorted(tables[0]) == sorted(tables[1])
    for k in tables[0]:
        np.testing.assert_array_equal(np.asarray(tables[1][k]), np.asarray(tables[0][k]),
                                      err_msg=k)


TRACK_K = 5
TRACK_FLAGS = ["--test_source", "real_test", "--num_points", "128", "--eval_repeat_num",
               str(TRACK_K), "--sampling_steps", "6", "--T0", "0.15", "--batch_size", "4"]
TRACK_NOISE = np.random.default_rng(1).normal(size=(8 * TRACK_K, 9)).astype(np.float32)


@pytest.fixture(scope="module")
def track_tree(tmp_path_factory):
    """Three Real/test scenes of three objects each: a frame of three
    instances is padded to four, and PC's mean corrector step and EDM's
    batch take the padded rows in."""
    from genpose_tpu_torch.data import synthetic

    root = tmp_path_factory.mktemp("track_pc_edm")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(synthetic, "render_scene",
                   functools.partial(synthetic.render_scene, n_instances=3))
        synthetic.make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1,
                                          n_real_scenes=3, seed=13)
    finally:
        mp.undo()
    return root


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_main_tracking_matches_jax(track_tree, case):
    """``main_tracking`` of both runners over three frames (the port's
    freezes its agents), the JAX runner's pose noise and sampler draws of
    each frame's keys handed to the port."""
    import jax

    from genpose_tpu.config import get_config as jax_get_config
    from genpose_tpu.runners import evaluation_tracking as jtr
    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results
    from genpose_tpu_torch.runners import evaluation_tracking as ttr
    from test_torch_tracking import _jax_draws as noise_draws

    root = track_tree / case
    nocs = str(track_tree / "nocs")
    for side in ("jax", "port"):
        make_synthetic_mrcnn_results(nocs, str(root / side), "real_test", tracking=True)
    flags = TRACK_FLAGS + RUNNER_CASES[case]
    jcfg = jax_get_config(["--data_path", nocs, "--result_dir", str(root / "jax")] + flags)
    tcfg = get_config(["--data_path", nocs, "--result_dir", str(root / "port")] + flags)
    js, je, ts, te = _pinned_pairs(jcfg, tcfg, (3, 4), TRACK_NOISE)

    # the JAX runner's keys: per frame (key, k_noise), then (key, k_sample)
    key, pose_keys, sample_keys = jax.random.PRNGKey(jcfg.seed), [], []
    for _ in range(3):
        key, k_n = jax.random.split(key)
        key, k_s = jax.random.split(key)
        pose_keys.append(k_n)
        sample_keys.append(k_s)
    _inject(ts, case, lambda: iter(sample_keys), tcfg.sampling_steps)

    poses, counts = {"jax": [], "port": []}, []

    def recorder(mod, side):
        real = mod.compute_RT_errors

        def rec(sRT, gt, cat_id, hv, names):
            poses[side].append(np.array(sRT, np.float64))
            return real(sRT, gt, cat_id, hv, names)
        return rec

    track_frame = ttr.track_frame

    def counted(cfg, s, e, batch, *args):
        counts.append(batch["zero_mean_pts"].shape[0])
        return track_frame(cfg, s, e, batch, *args)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtr, "PoseAgent", lambda cfg, mode: js if mode == "score" else je)
        mp.setattr(jtr, "compute_RT_errors", recorder(jtr, "jax"))
        mp.setattr(ttr, "compute_RT_errors", recorder(ttr, "port"))
        mp.setattr(ttr, "track_frame", counted)
        jm = jtr.main_tracking(jcfg, tracking=True, T0=jcfg.T0)
        n0 = frozen.dispatches
        tm = ttr.main_tracking(tcfg, tracking=True, T0=tcfg.T0, score_agent=ts, energy_agent=te,
                               noise_draws=lambda frame, n: noise_draws(pose_keys[frame], n))
    finally:
        mp.undo()
    assert counts == [3, 3, 3] and frozen.dispatches == n0 + 2 * 3  # padded to 4 each
    assert len(poses["port"]) == len(poses["jax"]) == 9
    for n, (got, want) in enumerate(zip(poses["port"], poses["jax"])):
        np.testing.assert_allclose(got, want, err_msg=f"instance {n}", **TOL)
    assert list(tm) == list(jm) and "all" in tm
    for name in jm:
        np.testing.assert_allclose(tm[name]["mean_error"], jm[name]["mean_error"], **TOL)
        assert tm[name]["5d5cm_acc"] == jm[name]["5d5cm_acc"]
