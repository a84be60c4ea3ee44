"""``PoseAgent.freeze`` and ``InferencePipeline.freeze`` of genpose_tpu_torch.

On the CPU the frozen programs run the same static-buffer code as on a card,
without the capture:

- a frozen ``sample`` (Heun and RK45, with and without ``init_x``) and a
  frozen ``get_energy`` equal the eager calls bit for bit from the same
  generator state, and consume the generator alike;
- ``InferencePipeline(...).freeze().predict`` equals the JAX pipeline's
  ``freeze().predict`` within 1e-4 (the serving tolerance,
  ``tests/test_torch_serving.py``), padded and chunked;
- after ``load_jax``, a ``train_step``, ``zero_head_outputs`` or
  ``perturb_`` the frozen path is not taken; a new ``freeze()`` then equals
  eager under the new weights.

The ``cuda`` case replays CUDA graphs on a card and skips elsewhere.  This
file imports JAX only inside the tests that compare with it, so the card's
machine runs the ``cuda`` case without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_freeze.py``.
"""

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.training import frozen
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.state import EMA
from genpose_tpu_torch.utils.weights import perturb_

CFG = dict(num_points=64, batch_size=2, eval_repeat_num=3, sampling_steps=4, T0=0.55)


def _agent(mode, seed, device="cpu", cfg=None):
    """An agent with non-zero heads and, for the score agent, an EMA shadow
    apart from the live parameters (a frozen copy of the wrong set disagrees)."""
    agent = PoseAgent(Config(**(cfg or CFG)), mode, device=device)
    perturb_(agent.model, seed=seed)
    if mode == "score":
        g = torch.Generator().manual_seed(seed + 100)
        agent.state.ema = EMA(0.999, {k: p + 0.01 * torch.randn(p.shape, generator=g).to(p.device)
                                      for k, p in agent.params().items()})
    return agent


def _batch(n, seed, n_pts=64, device="cpu"):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy((rng.normal(size=(n, n_pts, 3)) * 0.1).astype(np.float32)).to(device)
    center = pts.mean(dim=1)
    return {"zero_mean_pts": pts - center[:, None], "pts_center": center}


def _samples(agent, batch, sampler, init_x, seed=0):
    gen = torch.Generator(device=batch["zero_mean_pts"].device).manual_seed(seed)
    out = agent.sample(batch, generator=gen, repeat_num=3, sampler=sampler, T0=0.55,
                       init_x=init_x)
    return out, torch.randn(4, generator=gen, device=gen.device)  # the generator's next draws


@pytest.mark.parametrize("sampler", ["ode", "ode_adaptive"])
@pytest.mark.parametrize("with_init", [False, True], ids=["prior", "init_x"])
def test_frozen_sample_equals_eager(sampler, with_init):
    agent, batch = _agent("score", 1), _batch(2, 0)
    init = torch.randn(2, 9, generator=torch.Generator().manual_seed(3)) if with_init else None
    eager, eager_next = _samples(agent, batch, sampler, init)
    n0 = frozen.dispatches
    agent.freeze()
    got, got_next = _samples(agent, batch, sampler, init)
    again, _ = _samples(agent, batch, sampler, init)  # the same program, new inputs copied in
    assert frozen.dispatches == n0 + 2 and len(agent.frozen_programs().programs) == 1
    assert torch.equal(got, eager) and torch.equal(again, eager)
    assert torch.equal(got_next, eager_next)
    assert torch.isfinite(got).all() and got.shape == (2, 3, 9)


def test_frozen_get_energy_equals_eager():
    agent, batch = _agent("energy", 2), _batch(3, 1)
    poses = torch.randn(3, 3, 9, generator=torch.Generator().manual_seed(4))
    eager = agent.get_energy(batch, poses, T=1e-5)
    agent.freeze()
    n0 = frozen.dispatches
    got = agent.get_energy(batch, poses, T=1e-5)
    assert frozen.dispatches == n0 + 1
    assert torch.equal(got, eager) and got.shape == (3, 3, 2)
    # a second shape is a second program
    agent.get_energy(_batch(2, 2), poses[:2], T=1e-5)
    assert len(agent.frozen_programs().programs) == 2


@pytest.fixture(scope="module")
def pipes():
    from test_torch_serving import make_pipes

    return make_pipes("ode")


@pytest.mark.parametrize("n", [1, 5], ids=["padded", "chunked"])
def test_frozen_pipeline_matches_jax_frozen(pipes, n):
    import jax

    from test_torch_serving import _assert_same, _cloud

    jp, tp = pipes
    tp.score_agent._frozen = tp.energy_agent._frozen = None  # eager again
    pts = _cloud(n, seed=n)
    eager = tp.predict(pts)
    n0 = frozen.dispatches
    got = tp.freeze().predict(pts)
    assert frozen.dispatches == n0 + 2 * -(-n // tp.bs)
    for k in eager:
        np.testing.assert_array_equal(got[k], eager[k], err_msg=k)
    _assert_same(got, jp.freeze().predict(pts, key=jax.random.PRNGKey(0)))


def _train_step(agent):
    rng = np.random.default_rng(0)
    raw = synthetic_batch(rng, bs=2, n_pts=64, n_model=64)
    agent.train_step(process_batch(raw, device="cpu", generator=torch.Generator().manual_seed(0)),
                     generator=torch.Generator().manual_seed(1))


def _load_jax(agent):
    import jax

    from _torch_parity import train_agent

    st = train_agent(agent.cfg, agent.mode, seed=7).state
    agent.load_jax(jax.device_get(st.params), jax.device_get(st.batch_stats),
                   ema_shadow=jax.device_get(st.ema.shadow))


# each change, and whether it moves what ``sample`` reads (``perturb_``
# moves the live parameters, not the EMA shadow that sampling reads)
CHANGES = {
    "load_jax": (_load_jax, True),
    "train_step": (_train_step, True),
    "zero_head_outputs": (lambda agent: agent.zero_head_outputs(), True),
    "perturb_": (lambda agent: perturb_(agent.model, seed=9), False),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_weight_change_ends_the_frozen_path(change):
    agent, batch = _agent("score", 1), _batch(2, 0)
    before, _ = _samples(agent.freeze(), batch, "ode", None)
    fn, moves = CHANGES[change]
    fn(agent)
    assert agent.frozen_programs() is None
    n0 = frozen.dispatches
    eager, _ = _samples(agent, batch, "ode", None)
    assert frozen.dispatches == n0 and torch.equal(eager, before) != moves
    refrozen, _ = _samples(agent.freeze(), batch, "ode", None)
    assert frozen.dispatches == n0 + 1 and torch.equal(refrozen, eager)


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager():
    """On a card: the replayed graphs equal eager (Heun and RK45 samples,
    energies), and a second shape captures a second set of graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    dev = torch.device("cuda")
    cfg = dict(CFG, num_points=1024)
    score, energy = _agent("score", 1, dev, cfg), _agent("energy", 2, dev, cfg)
    batch = _batch(2, 0, n_pts=1024, device=dev)
    init = torch.randn(2, 9, device=dev)
    other = _batch(3, 1, n_pts=1024, device=dev)
    eager = {s: _samples(score, batch, s, init)[0] for s in ("ode", "ode_adaptive")}
    eager_other = _samples(score, other, "ode", None)[0]
    e_eager = energy.get_energy(batch, eager["ode"], T=1e-5)
    score.freeze()
    energy.freeze()
    for _ in range(2):  # the capture's call, then a replay
        for s in ("ode", "ode_adaptive"):
            assert torch.equal(_samples(score, batch, s, init)[0], eager[s]), s
        assert torch.equal(energy.get_energy(batch, eager["ode"], T=1e-5), e_eager)
    programs = score.frozen_programs().programs
    assert len(programs) == 2
    assert torch.equal(_samples(score, other, "ode", None)[0], eager_other)
    assert len(programs) == 3
    assert all(seg.graph is not None for p in programs.values() for seg in p.segments)
