"""Checkpoint interchange into genpose_tpu_torch, on the CPU.

(a) A JAX package checkpoint (orbax) -> ``tools/orbax_to_port.py`` -> the
    port's format: leaf by leaf equal to the JAX state (params, BatchNorm
    statistics, EMA shadow and count, Adam moments, step), the same samples,
    and a resumed step that follows the JAX step.
(b) A released GenPose ``.pth`` (the reference's torch layout, built here
    from seeded weights by ``chip_smoke.py::upstream_state_dict``) -> the
    port's weights, with no JAX: the JAX package's own porter first takes the
    fixture back to the weights it came from (which shows the fixture is in
    the released layout), then the port's porter must give exactly
    ``from_jax_variables(port_gf_state_dict(...))``, for a VE score model,
    an IP energy model and an EDM decoder score model; through
    ``genpose_tpu_torch/tools/port_torch_ckpt.py`` and
    ``InferencePipeline(score_ckpt=, energy_ckpt=)`` the pipeline equals the
    one filled by ``load_jax`` bit for bit.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import Config
from genpose_tpu.training.checkpoints import save_checkpoint as jax_save_checkpoint
from genpose_tpu.utils.torch_port import port_gf_state_dict as jax_port_gf_state_dict
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import load_checkpoint
from genpose_tpu_torch.utils import torch_port
from genpose_tpu_torch.utils.weights import from_jax_variables
from _torch_parity import jax_agent, pin_jax_prior, pin_port_prior, t_np, train_agent
from test_torch_training import _batches, _j, _t, dsm_noise

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from chip_smoke import upstream_state_dict  # noqa: E402

N_PTS = 128
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture
def one_torch_thread():
    """One PyTorch CPU thread for a test: the suite runs in several worker
    processes at once, and the many small ops of the samplers slow down
    severely when every worker runs a thread per core.  Not for the resumed
    step: its loss tolerance is ``test_torch_training.py``'s, which holds
    train-mode BatchNorm's float noise at PyTorch's default threading."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


def _assert_same_sd(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


# ---------------------------------------------------------------------------
# (a) orbax -> port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def orbax_route(tmp_path_factory):
    """A seeded JAX score agent after two Adam steps, saved with orbax and
    converted by ``tools/orbax_to_port.py``; the port agent loads the result."""
    import orbax_to_port

    flags = ["--num_points", str(N_PTS), "--batch_size", "2", "--repeat_num", "2",
             "--warmup", "2", "--lr", "1e-3", "--optimizer", "Adam"]
    kw = dict(num_points=N_PTS, batch_size=2, repeat_num=2, warmup=2, lr=1e-3,
              optimizer="Adam")
    js = train_agent(Config(gather_fwd="exact", gather_grad="exact", **kw), "score", seed=16)
    batches = _batches(3, seed=17)
    keys = jax.random.split(jax.random.PRNGKey(18), 3)
    for n in range(2):
        js.train_step(_j(batches[n]), keys[n])
    root = tmp_path_factory.mktemp("orbax")
    src = jax_save_checkpoint(str(root / "jax"), js.state, epoch=2,
                              clock={"epoch": 2, "minibatch": 0, "step": 2})
    out = orbax_to_port.main(["--input", src, "--output", str(root / "port"), *flags])
    assert Path(out).name == "ckpt_epoch2"
    assert json.loads((root / "port" / "clock.json").read_text())["step"] == 2
    tcfg = TorchConfig(**kw)
    ts = PoseAgent(tcfg, "score", device="cpu")
    load_checkpoint(out, ts)
    return js, ts, batches, keys


def test_orbax_route_carries_every_leaf(orbax_route):
    """params, BatchNorm statistics, EMA shadow and count, Adam moments and
    step: exactly the JAX state's values."""
    js, ts, _, _ = orbax_route
    st = jax.device_get(js.state)
    _assert_same_sd(ts.model.state_dict(), from_jax_variables(st.params, st.batch_stats))
    names = set(ts.params())
    shadow = from_jax_variables(st.ema.shadow, {})
    _assert_same_sd(ts.state.ema.shadow, {k: shadow[k] for k in names})
    assert ts.state.ema.num_updates == int(st.ema.num_updates) == 2
    assert ts.state.step == int(st.step) == 2
    adam = st.opt_state[1][0]
    for m in ("mu", "nu"):
        sd = from_jax_variables(getattr(adam, m), {})
        _assert_same_sd(ts.state.opt_state[m], {k: sd[k] for k in names})


def test_orbax_route_samples_as_jax(orbax_route):
    """Heun samples of the converted agent (its EMA shadow) against the JAX
    agent's, same prior rows: within 1e-4 scaled."""
    js, ts, _, _ = orbax_route
    rng = np.random.default_rng(19)
    noise = rng.normal(size=(2 * 3, 9)).astype(np.float32)
    pin_jax_prior(js, noise)
    pin_port_prior(ts, noise)
    pts = (rng.normal(size=(2, N_PTS, 3)) * 0.1).astype(np.float32)
    center = rng.normal(size=(2, 3)).astype(np.float32)
    want = np.asarray(js.sample({"zero_mean_pts": jnp.asarray(pts),
                                 "pts_center": jnp.asarray(center)},
                                jax.random.PRNGKey(0), repeat_num=3, num_steps=4, T0=0.55))
    got = ts.sample({"zero_mean_pts": t_np(pts), "pts_center": t_np(center)}, repeat_num=3,
                    num_steps=4, T0=0.55).numpy()
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) <= 1e-4


def test_orbax_route_resumes_as_jax(orbax_route):
    """The third Adam step from the converted checkpoint against JAX's third
    step, held as ``test_torch_training.py::test_resume_from_a_jax_state_mid_trajectory``
    holds it: loss rtol 1e-5; head moments atol 1e-3 of the tensor's
    largest and params atol 5e-2 lr; encoder moments atol 5% of the
    model's largest moment and params atol 2.5 lr."""
    js, ts, batches, keys = orbax_route
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


# ---------------------------------------------------------------------------
# (b) released .pth -> port
# ---------------------------------------------------------------------------

MODELS = {"ve_score": ("ve", "score"), "ip_energy": ("ve", "energy"),
          "edm_decoder_score": ("edm", "score")}


@pytest.fixture(scope="module")
def upstream():
    """Per model: the JAX agent's weights, their released-layout state_dict
    and the port agent (CPU) of the same configuration."""
    out = {}
    for i, (name, (sde, mode)) in enumerate(MODELS.items()):
        jag = jax_agent(Config(num_points=N_PTS, sde_mode=sde), mode, seed=30 + i)
        st = jax.device_get(jag.state)
        decoder = sde == "edm" and mode == "score"
        sd = upstream_state_dict(st.params, st.batch_stats, decoder_head=decoder)
        tag = PoseAgent(TorchConfig(num_points=N_PTS, sde_mode=sde), mode, device="cpu")
        out[name] = dict(jag=jag, st=st, sd=sd, tag=tag, decoder=decoder)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_upstream_fixture_is_what_the_jax_porter_reads(upstream, name):
    """JAX's ``port_gf_state_dict`` takes the fixture back to the exact JAX
    weights it was made from."""
    u = upstream[name]
    back = jax_port_gf_state_dict(u["sd"], u["jag"].state.variables,
                                  decoder_head=u["decoder"])
    _assert_same_tree(back["params"], u["st"].params)
    _assert_same_tree(back.get("batch_stats", {}), u["st"].batch_stats)
    assert u["decoder"] == ("sigma_encoder" in " ".join(u["sd"]))


@pytest.mark.parametrize("name", list(MODELS))
def test_port_porter_equals_jax_porter_composed(upstream, name):
    """The port's porter = ``from_jax_variables ∘ port_gf_state_dict``,
    exactly, and the port's model loads it."""
    u = upstream[name]
    back = jax_port_gf_state_dict(u["sd"], u["jag"].state.variables,
                                  decoder_head=u["decoder"])
    want = from_jax_variables(back["params"], back.get("batch_stats", {}))
    got = torch_port.port_state_dict(u["sd"], u["tag"].model)
    _assert_same_sd(got, want)
    u["tag"].model.load_state_dict(got)


@pytest.mark.parametrize("fault", ["missing_key", "wrong_shape"])
def test_port_porter_refuses_a_bad_checkpoint(upstream, fault):
    u = upstream["ve_score"]
    sd = dict(u["sd"])
    if fault == "missing_key":
        del sd["pose_score_net.pose_encoder.2.weight"]
        with pytest.raises(KeyError):
            torch_port.port_state_dict(sd, u["tag"].model)
    else:
        sd["pose_score_net.pose_encoder.2.weight"] = torch.zeros(256, 255)
        with pytest.raises(ValueError, match="shape mismatch"):
            torch_port.port_state_dict(sd, u["tag"].model)


def test_released_pth_serves_as_load_jax(upstream, tmp_path, one_torch_thread):
    """Released-layout ``.pth`` files of a score and an energy model ->
    ``genpose_tpu_torch/tools/port_torch_ckpt.py`` -> ``InferencePipeline(
    score_ckpt=, energy_ckpt=)``: predictions equal those of the pipeline
    filled by ``load_jax`` with the same weights, bit for bit."""
    from genpose_tpu_torch.tools import port_torch_ckpt

    paths = {}
    for name, mode in (("ve_score", "score"), ("ip_energy", "energy")):
        pth = tmp_path / f"{name}.pth"
        torch.save({"model_state_dict": upstream[name]["sd"],
                    "clock": {"epoch": 7, "minibatch": 0, "step": 700}}, pth)
        paths[mode] = port_torch_ckpt.main(["--input", str(pth), "--output",
                                            str(tmp_path / name), "--posenet_mode", mode,
                                            "--num_points", str(N_PTS)])
        assert Path(paths[mode]).name == "ckpt_epoch7"
    cfg = TorchConfig(num_points=N_PTS, batch_size=2, eval_repeat_num=3, sampling_steps=4,
                      T0=0.55)
    got = InferencePipeline(cfg, device="cpu", score_ckpt=paths["score"],
                            energy_ckpt=paths["energy"])
    want = InferencePipeline(cfg, device="cpu")
    for agent, name in ((want.score_agent, "ve_score"), (want.energy_agent, "ip_energy")):
        st = upstream[name]["st"]
        agent.load_jax(st.params, st.batch_stats)
    pts = (np.random.default_rng(40).normal(size=(3, N_PTS, 3)) * 0.1).astype(np.float32)
    a, b = got.predict(pts), want.predict(pts)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.isfinite(a["energy"]).all() and np.abs(a["energy"]).max() > 0
