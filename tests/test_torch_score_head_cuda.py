"""The fused score-head kernel (``csrc/score_head.cu``) on the card.

Marked ``cuda``: skips without an NVIDIA GPU and the CUDA toolkit (decided
in the fixture).  The card's machine has no JAX: run
``python -m pytest --noconftest -m cuda tests/test_torch_score_head_cuda.py``.

- The kernel against the plain arithmetic (``score_head_ref``) at rows 1,
  97, 12,800 (the evaluation shape: 256 clouds x 50 hypotheses, fp folded
  by ``repeat_interleave`` as ``PoseAgent._head_projs`` folds it), 12,801
  and 30,000 (more rows than one wave of blocks holds), at t = 1e-5, 0.3,
  0.55 and 1.0, and for the single 512-wide ``RT`` tail.  Tolerance: both
  compute in IEEE float32 and differ in the order of their sums (cuBLAS's
  blocking against the kernel's k-order chains and lane reductions) over
  four layers of K <= 256, a few 1e-7 of the output's scale each; held to
  1e-5 of the largest output.
- The kernel is deterministic: two calls, and a CUDA graph's replay, give
  the eager call's bits.
- Counters: a frozen Heun-500 request captures 999 fused evaluations and
  no plain one (``frozen.capture``'s ``fused_evals``); a score training
  step calls the kernel 0 times.
"""

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.models.scorenet import PoseScoreNet
from genpose_tpu_torch.ops import score_head_cuda
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.weights import perturb_

pytestmark = pytest.mark.cuda

TOL = 1e-5  # of the largest |output|: float32 sums in two orders (module docstring)
K = 50


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _net(dev, seed=0, **kw):
    net = PoseScoreNet(init_sde("ve").marginal_prob, **kw)
    return perturb_(net, seed=seed, scale=0.05).to(dev).eval().requires_grad_(False)


def _inputs(net, dev, rows, seed=1):
    """fp from ceil(rows / K) clouds folded K times, cut to ``rows``; poses
    at the prior's scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    clouds = -(-rows // K)
    feat = torch.randn(clouds, 1024, generator=g, device=dev).relu()
    fp = net.precompute(feat).repeat_interleave(K, dim=0)[:rows].contiguous()
    return fp, torch.randn(rows, 9, generator=g, device=dev)


def _both(net, fp, x, t):
    _, std = net.marginal_prob_fn(None, t)
    std = torch.reshape(std, (-1, 1))
    with torch.no_grad():
        got = score_head_cuda.score_head(net.trunk, fp, x, t, std)
        want = score_head_cuda.score_head_ref(net.trunk, fp, x, t, std)
    torch.cuda.synchronize()
    return got, want


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("t", [1e-5, 0.3, 0.55, 1.0])
@pytest.mark.parametrize("rows", [1, 97, 12800, 12801, 30000])
def test_kernel_equals_plain(dev, rows, t):
    net = _net(dev)
    fp, x = _inputs(net, dev, rows)
    got, want = _both(net, fp, x, torch.full((1, 1), t, device=dev))
    assert got.shape == want.shape == (rows, 9)
    assert torch.isfinite(got).all()
    assert _gap(got, want) <= TOL, _gap(got, want)


def test_kernel_equals_plain_for_one_wide_tail(dev):
    net = _net(dev, seed=2, regression_head="RT")
    fp, x = _inputs(net, dev, 97, seed=3)
    got, want = _both(net, fp, x, torch.full((1, 1), 0.3, device=dev))
    assert _gap(got, want) <= TOL, _gap(got, want)


def test_kernel_is_deterministic_and_replays_bit_for_bit(dev):
    net = _net(dev)
    fp, x = _inputs(net, dev, 12800)
    t = torch.full((1, 1), 0.55, device=dev)
    with torch.no_grad():
        first = net.score_from(fp, x, t)
        second = net.score_from(fp, x, t)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            net.score_from(fp, x, t)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = net.score_from(fp, x, t)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(captured, first)


def test_frozen_heun_500_capture_runs_999_fused_evaluations(dev):
    pipe = InferencePipeline(Config(num_points=1024, batch_size=2, eval_repeat_num=K,
                                    sampling_steps=500, T0=0.55), device=dev)
    perturb_(pipe.score_agent.model, seed=1)
    perturb_(pipe.energy_agent.model, seed=2)
    pipe.freeze()
    pts = (np.random.default_rng(0).normal(size=(2, 1024, 3)) * 0.1 + [0, 0, 1]).astype(
        np.float32)
    trace.drain()
    trace.enable()
    try:
        c0 = trace.snapshot()
        pipe.predict(pts)              # captures the sample and energy programs
        records, c1 = trace.drain()
        pipe.predict(pts)              # replays them
        _, c2 = trace.drain()
    finally:
        trace.disable()
    caps = {r["attrs"]["kind"]: r["attrs"] for r in records if r["name"] == "frozen.capture"}
    assert caps["sample"]["fused_evals"] == 2 * 499 + 1
    assert caps["energy"]["fused_evals"] == 0
    assert c1["score_head.plain"] == c0["score_head.plain"]
    # warm-up and capture each call score_from; replays call nothing
    assert c1["score_head.fused"] - c0["score_head.fused"] == 2 * 999
    assert (c2["score_head.fused"], c2["score_head.plain"]) == (
        c1["score_head.fused"], c1["score_head.plain"])


def test_score_training_step_calls_no_kernel(dev):
    cfg = Config(num_points=1024, batch_size=4, repeat_num=2)
    agent = PoseAgent(cfg, "score", device=dev)
    perturb_(agent.model, seed=5)
    raw = synthetic_batch(np.random.default_rng(0), bs=4, n_pts=1024, n_model=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = process_batch(raw, cfg.pose_mode, generator=gen, pts_aug_params=cfg.pts_aug,
                          device=dev)
    c0, launches = trace.snapshot(), score_head_cuda.launches
    agent.train_step(batch, generator=gen)
    agent.ema_loss(batch, generator=gen)
    torch.cuda.synchronize()
    c1 = trace.snapshot()
    assert c1["score_head.fused"] == c0["score_head.fused"]
    assert c1["score_head.plain"] > c0["score_head.plain"]
    assert score_head_cuda.launches == launches
