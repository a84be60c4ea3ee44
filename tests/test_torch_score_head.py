"""Which score evaluations take the fused head kernel (``ops/score_head_cuda.py``).

``PoseScoreNet.score_from`` routes on what its inputs show
(``models/scorenet.py::fused_head_applies``).  Here, on the CPU, the card is
simulated (``scorenet._on_card`` reads True) and the kernel replaced by a
spy that computes the plain arithmetic, so each condition is tested alone:

- float32 fused tails, a step-shared t [1, 1], no autograd: the kernel;
- per-row t, grad enabled, a bfloat16 head, split tails, per-point tails,
  the EDM decoder and CPU tensors: the plain arithmetic, bit for bit what
  ``score_from`` computed before the kernel existed;
- a score training step and the EMA loss (per-row t) never call it, even
  "on a card";
- the counters ``score_head.fused`` / ``score_head.plain`` count the calls
  of each path; the wrapper refuses CPU tensors.

The kernel itself is held against the plain arithmetic on the card in
``tests/test_torch_score_head_cuda.py``.
"""

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.models import scorenet
from genpose_tpu_torch.ops import score_head_cuda
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.weights import perturb_

ROWS = 6


@pytest.fixture
def card(monkeypatch):
    """A simulated card: every tensor reads as a CUDA tensor to the router,
    and the kernel is a spy over the plain arithmetic.  Yields the spy's
    calls."""
    calls = []

    def spy(trunk, fp, x, t, std):
        calls.append(x.shape)
        return score_head_cuda.score_head_ref(trunk, fp, x, t, std)

    monkeypatch.setattr(scorenet, "_on_card", lambda x: True)
    monkeypatch.setattr(score_head_cuda, "score_head", spy)
    return calls


def _net(seed=0, **kw):
    net = scorenet.PoseScoreNet(init_sde("ve").marginal_prob, **kw)
    return perturb_(net, seed=seed, scale=0.05).eval().requires_grad_(False)


def _inputs(net, rows=ROWS, seed=1, pts_feat_shape=None):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(pts_feat_shape or (rows, 1024), generator=g).relu()
    return net.precompute(feat), torch.randn(rows, 9, generator=g)


def _plain(net, projs, x, t):
    """``score_from``'s arithmetic as it was before the kernel."""
    _, std = net.marginal_prob_fn(None, t)
    std = torch.reshape(std, (-1, 1))
    return net.trunk.f_theta_from(projs, x, t) / (std + 1e-7)


def _counts():
    snap = trace.snapshot()
    return snap["score_head.fused"], snap["score_head.plain"]


def test_the_sampler_evaluation_takes_the_kernel(card):
    net = _net()
    projs, x = _inputs(net)
    t = torch.full((1, 1), 0.3)
    f0, p0 = _counts()
    with torch.no_grad():
        got = net.score_from(projs, x, t)
    assert card == [(ROWS, 9)]
    assert _counts() == (f0 + 1, p0)
    assert torch.equal(got, _plain(net, projs, x, t))


def _bypass_per_row_t(monkeypatch):
    net = _net()
    projs, x = _inputs(net)
    return net, projs, x, torch.full((ROWS, 1), 0.3), torch.no_grad


def _bypass_grad(monkeypatch):
    net = _net()
    projs, x = _inputs(net)
    return net, projs, x, torch.full((1, 1), 0.3), torch.enable_grad


def _bypass_bf16(monkeypatch):
    net = _net(dtype=torch.bfloat16)
    projs, x = _inputs(net)
    return net, projs, x, torch.full((1, 1), 0.3), torch.no_grad


def _bypass_split_tails(monkeypatch):
    net = _net(regression_head="R_and_T")
    projs, x = _inputs(net)
    return net, projs, x, torch.full((1, 1), 0.3), torch.no_grad


def _bypass_per_point(monkeypatch):
    net = _net(per_point_feature=True, pts_feat_dim=1280)
    projs, x = _inputs(net, rows=2, pts_feat_shape=(2, 16, 1280))
    return net, projs, x, torch.full((1, 1), 0.3), torch.no_grad


def _bypass_cpu(monkeypatch):
    monkeypatch.setattr(scorenet, "_on_card", lambda x: x.is_cuda)  # the real router
    net = _net()
    projs, x = _inputs(net)
    return net, projs, x, torch.full((1, 1), 0.3), torch.no_grad


@pytest.mark.parametrize("case", [_bypass_per_row_t, _bypass_grad, _bypass_bf16,
                                  _bypass_split_tails, _bypass_per_point, _bypass_cpu],
                         ids=["per_row_t", "grad_enabled", "bfloat16_head", "split_tails",
                              "per_point_tails", "cpu_tensors"])
def test_each_bypass_runs_the_plain_arithmetic(card, monkeypatch, case):
    net, projs, x, t, mode = case(monkeypatch)
    f0, p0 = _counts()
    with mode():
        got = net.score_from(projs, x, t)
    assert card == []
    assert _counts() == (f0, p0 + 1)
    with mode():
        assert torch.equal(got, _plain(net, projs, x, t))


def test_the_edm_decoder_never_takes_the_kernel(card):
    net = scorenet.PoseDecoderNet(init_sde("edm").marginal_prob)
    perturb_(net, seed=3, scale=0.05).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(4)
    projs = net.precompute(torch.randn(ROWS, 1024, generator=g).relu())
    x, t = torch.randn(ROWS, 9, generator=g), torch.full((1, 1), 0.5)
    before = _counts()
    with torch.no_grad():
        net.score_from(projs, x, t)
        net.denoise_from(projs, x, t)
    assert card == [] and _counts() == before


def test_training_never_takes_the_kernel(card):
    """A score step (grad enabled, per-row t) and the EMA loss (per-row t)
    run the plain arithmetic only, though the router sees a card."""
    cfg = Config(num_points=64, batch_size=4, repeat_num=2)
    agent = PoseAgent(cfg, "score", device="cpu")
    perturb_(agent.model, seed=5)
    raw = synthetic_batch(np.random.default_rng(0), bs=4, n_pts=64, n_model=128)
    gen = torch.Generator().manual_seed(0)
    batch = process_batch(raw, cfg.pose_mode, generator=gen, pts_aug_params=cfg.pts_aug,
                          device="cpu")
    f0, p0 = _counts()
    agent.train_step(batch, generator=gen)
    agent.ema_loss(batch, generator=gen)
    fused, plain = _counts()
    assert card == [] and fused == f0 and plain > p0


def test_the_wrapper_refuses_cpu_tensors():
    net = _net()
    projs, x = _inputs(net)
    t = torch.full((1, 1), 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        score_head_cuda.score_head(net.trunk, projs, x, t, t)
