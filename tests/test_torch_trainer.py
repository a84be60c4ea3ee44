"""The port's training loops on the CPU at a small size (64 points, batches
of 2, 2 DSM draws, 3 sampler steps): ``train_score`` and
``train_energy`` run, write checkpoints and metrics, reload and resume.
Port only: the step arithmetic is held against the JAX package in
``tests/test_torch_training.py``."""

import json
import os

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.models import pointnet2
from genpose_tpu_torch.runners.trainer import results_dirs, train_energy, train_score
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import latest_checkpoint, load_checkpoint, load_clock
from genpose_tpu_torch.training.state import create_train_state
from genpose_tpu_torch.utils.logging import TrainClock
from genpose_tpu_torch.utils.weights import perturb_

CFG = Config(num_points=64, batch_size=2, mini_bs=2, repeat_num=2, warmup=1, n_epochs=2,
             eval_freq=1, sampling_steps=3, log_dir="t")


def _loader(seed, n=1):
    rng = np.random.default_rng(seed)
    return [synthetic_batch(rng, bs=2, n_pts=64, n_model=128) for _ in range(n)]


def _agent(mode, seed, cfg=CFG):
    agent = PoseAgent(cfg, mode, device="cpu", steps_per_epoch=1)
    perturb_(agent.model, seed=seed)
    return agent


def _same_state(a: PoseAgent, b: PoseAgent):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert a.state.step == b.state.step
    assert a.state.ema.num_updates == b.state.ema.num_updates
    for k, v in a.state.ema.shadow.items():
        assert torch.equal(v, b.state.ema.shadow[k]), k
    for m, sd in a.state.opt_state.items():
        for k, v in sd.items():
            assert torch.equal(v, b.state.opt_state[m][k]), (m, k)


def test_first_step_has_lr_zero_and_the_ema_and_bn_move():
    agent = _agent("score", seed=1)
    batch = process_batch(_loader(0)[0], device="cpu")
    params0 = {k: p.clone() for k, p in agent.params().items()}
    stats0 = {k: v.clone() for k, v in agent.model.state_dict().items() if "running" in k}
    gen = torch.Generator().manual_seed(0)
    agent.train_step(batch, gen)
    assert all(torch.equal(p, params0[k]) for k, p in agent.params().items())
    assert agent.state.step == 1 and agent.state.ema.num_updates == 1
    assert any(not torch.equal(v, stats0[k]) for k, v in agent.model.state_dict().items()
               if "running" in k)
    agent.train_step(batch, gen)
    changed = [k for k, p in agent.params().items() if not torch.equal(p, params0[k])]
    assert len(changed) == len(params0)
    shadow = agent.state.ema.shadow
    assert any(not torch.equal(shadow[k], p) for k, p in agent.params().items())
    with agent.ema_weights():
        assert torch.equal(agent.model.head.trunk.t_dense.weight,
                           shadow["head.trunk.t_dense.weight"])
    assert not agent.model.training and not any(p.requires_grad for p in agent.params().values())


def test_train_score_writes_reloads_and_resumes(tmp_path):
    agent = _agent("score", seed=2)
    loader = _loader(1)
    clock = train_score(CFG, loader, loader, agent, out_dir=str(tmp_path))
    assert clock.make_checkpoint() == {"epoch": 3, "minibatch": 0, "step": 2}
    ckpt_dir, log_dir = results_dirs(CFG, str(tmp_path))
    path = latest_checkpoint(ckpt_dir)
    assert os.path.basename(path) == "ckpt_epoch3"
    assert load_clock(ckpt_dir) == clock.make_checkpoint()
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"train/ode_mean_rot_error", "val/ode_mean_trans_error", "epoch_time_s"} <= tags

    fresh = PoseAgent(CFG, "score", device="cpu", steps_per_epoch=1)
    load_checkpoint(path, fresh)
    _same_state(agent, fresh)
    weights_only = PoseAgent(CFG, "score", device="cpu")
    load_checkpoint(path, weights_only, load_model_only=True)
    assert weights_only.state.step == 0 and weights_only.state.opt_state is None

    fresh.clock = TrainClock()
    fresh.clock.restore_checkpoint(load_clock(ckpt_dir))
    train_score(CFG.replace(n_epochs=3), loader, loader, fresh, out_dir=str(tmp_path))
    assert fresh.state.step == 3
    assert os.path.basename(latest_checkpoint(ckpt_dir)) == "ckpt_epoch4"


def test_train_energy_with_ranking_shares_one_geometry_pass(tmp_path, monkeypatch):
    """One FPS per SA stage per iteration: the candidates' sampling computes
    the geometry and the energy step reuses it."""
    calls = []
    fps = pointnet2.farthest_point_sample
    monkeypatch.setattr(pointnet2, "farthest_point_sample",
                        lambda *a: calls.append(1) or fps(*a))
    cfg = CFG.replace(n_epochs=1, eval_freq=5)
    score, energy = _agent("score", seed=3, cfg=cfg), _agent("energy", seed=4, cfg=cfg)
    loader = _loader(2, n=2)
    train_energy(cfg, loader, loader, energy, score, ranking=True, out_dir=str(tmp_path))
    assert energy.state.step == 2 and score.state.step == 0
    assert len(calls) == 3 * 2
    fresh = PoseAgent(cfg, "energy", device="cpu")
    load_checkpoint(latest_checkpoint(results_dirs(cfg, str(tmp_path))[0]), fresh)
    _same_state(energy, fresh)


def test_train_energy_without_ranking_distills(tmp_path):
    cfg = CFG.replace(n_epochs=1, eval_freq=5)
    teacher, student = _agent("score", seed=5, cfg=cfg), _agent("energy", seed=6, cfg=cfg)
    teacher.zero_head_outputs()
    assert teacher.state.ema.shadow is None
    train_energy(cfg, _loader(3), _loader(3), student, teacher, ranking=False,
                 out_dir=str(tmp_path))
    assert student.state.step == 1
    with pytest.raises(ValueError):
        train_energy(cfg, _loader(3), _loader(3), student, None, ranking=True,
                     out_dir=str(tmp_path))


def _per_tensor_update(state, params, grads):
    """clip -> Adam or SGD -> EMA written tensor by tensor, the arithmetic
    that ``TrainState.apply_gradients`` runs as multi-tensor ops."""
    if state.ema.shadow is None:
        state.ema.shadow = {k: p.clone() for k, p in params.items()}
    if state.opt_state is None:
        state.opt_state = state._init_opt_state(params)
    if state.grad_clip > 0:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        grads = {k: torch.where(norm < state.grad_clip, g, (g / norm) * state.grad_clip)
                 for k, g in grads.items()}
    lr, count = state.schedule(state.step), state.step + 1
    for k, p in params.items():
        g = grads[k]
        if state.optimizer == "Adam":
            c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(count))
            c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(count))
            mu, nu = state.opt_state["mu"], state.opt_state["nu"]
            mu[k] = (1 - 0.9) * g + 0.9 * mu[k]
            nu[k] = (1 - 0.999) * (g * g) + 0.999 * nu[k]
            update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8)
        else:
            trace = state.opt_state["trace"]
            trace[k] = (g + 1e-4 * p) + 0.9 * trace[k]
            update = trace[k]
        p.copy_(p + (-lr) * update)
    state.step = count
    n = state.ema.num_updates + 1
    decay = np.minimum(np.float32(0.999), (np.float32(1) + np.float32(n)) /
                       (np.float32(10) + np.float32(n)))
    for k, p in params.items():
        s = state.ema.shadow[k]
        s.sub_((s - p) * float(np.float32(1) - decay))
    state.ema.num_updates = n


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.3, 0.0])
def test_multi_tensor_update_is_the_per_tensor_arithmetic(grad_clip, optimizer, device):
    """30 updates of params of several shapes, gradients from 1e-8 to 3
    (norms either side of the clip; ``grad_clip`` 0 turns it off): params,
    moments and EMA shadow bit for bit."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    rng = np.random.RandomState(0)
    shapes = {"a": (40, 70), "b": (160,), "c": (3, 3, 5), "d": (2,), "e": (512, 300)}
    init = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
            for k, s in shapes.items()}
    kw = dict(base_lr=1e-3, warmup_steps=3, decay_per_epoch=0.3, steps_per_epoch=4,
              grad_clip=grad_clip, ema_rate=0.999, optimizer=optimizer)
    fused, plain = create_train_state(**kw), create_train_state(**kw)
    pf = {k: v.clone() for k, v in init.items()}
    pp = {k: v.clone() for k, v in init.items()}
    clipped = 0
    for n in range(30):
        scale = 10.0 ** rng.randint(-6, 3) / 30
        g = {k: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32)).to(device)
             for k, s in shapes.items()}
        clipped += float(torch.sqrt(sum(torch.sum(x * x) for x in g.values()))) >= 1.0
        fused.apply_gradients(pf, g)
        with torch.no_grad():
            _per_tensor_update(plain, pp, g)
        for k in shapes:
            assert torch.equal(pf[k], pp[k]), (n, k)
            assert torch.equal(fused.ema.shadow[k], plain.ema.shadow[k]), (n, k)
            for m in fused.opt_state:
                assert torch.equal(fused.opt_state[m][k], plain.opt_state[m][k]), (n, k, m)
    assert 0 < clipped < 30  # norms on both sides of 1.0 (and of 0.3)
