"""The eval-mode grouped SA stage kernel (``csrc/sa_stage.cu``) on the card.

Marked ``cuda``: skips without an NVIDIA GPU and the CUDA toolkit (decided
in the fixture).  The card's machine has no JAX: run
``python -m pytest --noconftest -m cuda tests/test_torch_sa_stage_cuda.py``.

- Each ``light`` stage 0-2 and radius against the plain arithmetic
  (``sa_stage_ref``) at B = 1, 3 and 256, on object-sized clouds half of
  whose points lie far from the rest, so that many balls hold fewer points
  than nsample and are padded by repeated indices; BatchNorm's running
  statistics and affine drawn away from the identity.  Tolerance: both
  compute in IEEE float32 and differ in the order of their sums (cuBLAS's
  blocking against the kernel's k-order chains) over three layers of K <=
  259 and in the BatchNorm's rounding, a few 1e-7 of the output's scale
  each; held to 1e-5 of the largest output.
- The kernel is deterministic: two calls, and a CUDA graph's replay, give
  the eager call's bits.
- Every other encoder whose stages share an instantiation runs them through
  it within the same tolerance of its plain pass (grad enabled, so every
  stage plain): ``full`` (stages 0-2), ``dense`` (stage 1; its stages 0 and
  2 have 64- and 8-sample radii), the segmentation ``Pointnet2MSG``
  (stages 0-2); ``lighter`` has none.
- Frozen = eager bit for bit through ``InferencePipeline``; the captured
  Heun and energy programs each run the 6 grouped radii of the light
  stages 0-2 through the kernel and none plain (``frozen.capture``'s
  ``fused_sa``); a score training step runs them plain, never the kernel.
"""

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.models.pointnet2 import Pointnet2ClsMSG, Pointnet2MSG, cls_msg_geometry
from genpose_tpu_torch.ops import sa_stage_cuda
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.weights import perturb_

pytestmark = pytest.mark.cuda

TOL = 1e-5  # of the largest |output|: float32 sums in two orders (module docstring)
N_POINTS = 1024
K = 50


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _encoder(dev, seed=0):
    """The light encoder with perturbed weights and BatchNorm statistics."""
    enc = perturb_(Pointnet2ClsMSG("light"), seed=seed, scale=0.05)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in enc.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 1.5 + 0.25)
    return enc.to(dev).eval().requires_grad_(False)


def _clouds(dev, B, seed=0):
    """Ellipsoid surfaces of 3-15 cm with 2 mm noise, half of each cloud's
    points moved 0.5-1 m away and spread, so that their balls are sparse."""
    g = torch.Generator(device=dev).manual_seed(seed)
    axes = torch.rand(B, 1, 3, generator=g, device=dev) * 0.12 + 0.03
    d = torch.randn(B, N_POINTS, 3, generator=g, device=dev)
    pts = d / d.norm(dim=-1, keepdim=True) * axes
    pts = pts + torch.randn(B, N_POINTS, 3, generator=g, device=dev) * 0.002
    far = torch.randn(B, N_POINTS // 2, 3, generator=g, device=dev) * 0.5
    pts[:, N_POINTS // 2:] += far + far.sign() * 0.5
    return pts.contiguous()


def _stage_inputs(enc, pts):
    """Each grouped stage's (module, geometry, input features), the plain
    path's features carried from stage to stage."""
    geoms = cls_msg_geometry(pts, "light")
    feats, out = None, []
    with torch.no_grad():
        for k in range(3):
            sa = getattr(enc, f"sa_{k}")
            out.append((sa, geoms[k], feats))
            feats = torch.cat([sa_stage_cuda.sa_stage_ref(getattr(sa, f"mlp_{i}"),
                                                          geoms[k]["grouped_xyz"][i], feats,
                                                          geoms[k]["gidx"][i])
                               for i in range(sa.n_scales)], dim=-1)
    return out


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def stages(dev):
    enc = _encoder(dev)
    return {B: _stage_inputs(enc, _clouds(dev, B, seed=B)) for B in (1, 3, 256)}


@pytest.mark.parametrize("B", [1, 3, 256])
@pytest.mark.parametrize("stage,radius", [(k, i) for k in range(3) for i in range(2)])
def test_kernel_equals_plain(dev, stages, B, stage, radius):
    sa, geom, feats = stages[B][stage]
    mlp = getattr(sa, f"mlp_{radius}")
    gxyz, gidx = geom["grouped_xyz"][radius], geom["gidx"][radius]
    S = gidx.shape[-1]
    padded = (gidx[..., 1:] == gidx[..., :1]).any(-1).float().mean()
    assert padded > 0.05, f"too few padded balls to test them: {float(padded)}"
    width = sa_stage_cuda.widths(mlp)[-1]
    out = torch.full((B, gidx.shape[1], width + 8), float("nan"), device=dev)
    with torch.no_grad():
        sa_stage_cuda.sa_stage(mlp, gxyz, feats, gidx, out, 8)
        want = sa_stage_cuda.sa_stage_ref(mlp, gxyz, feats, gidx)
    torch.cuda.synchronize()
    got = out[..., 8:]
    assert torch.isnan(out[..., :8]).all(), "columns outside the radius' slice were written"
    assert torch.isfinite(got).all()
    assert _gap(got, want) <= TOL, (S, _gap(got, want))


def test_stages_are_deterministic_and_replay_bit_for_bit(dev, stages):
    enc = _encoder(dev)
    pts = _clouds(dev, 256, seed=7)
    geoms = cls_msg_geometry(pts, "light")
    with torch.no_grad():
        first = enc(pts, geometry=geoms)
        second = enc(pts, geometry=geoms)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            enc(pts, geometry=geoms)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = enc(pts, geometry=geoms)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(captured, first)


@pytest.mark.parametrize("config,fused", [("full", 6), ("dense", 2), ("lighter", 0),
                                          ("msg", 6)])
def test_other_encoders_equal_their_plain_pass(dev, config, fused):
    if config == "msg":
        enc = perturb_(Pointnet2MSG(cls_head=False), seed=4, scale=0.05)
    else:
        enc = perturb_(Pointnet2ClsMSG(config), seed=4, scale=0.05)
    enc = enc.to(dev).eval().requires_grad_(False)
    pts = _clouds(dev, 8, seed=5)
    with torch.no_grad():
        c0 = trace.snapshot()
        got = enc(pts)
        c1 = trace.snapshot()
        with torch.enable_grad():  # no parameter needs it: every stage plain
            want = enc(pts)
    torch.cuda.synchronize()
    assert c1["sa_stage.fused"] - c0["sa_stage.fused"] == fused
    assert _gap(got, want) <= TOL, _gap(got, want)


def test_frozen_equals_eager_and_captures_the_fused_stages(dev):
    cfg = Config(num_points=N_POINTS, batch_size=4, eval_repeat_num=K, sampling_steps=20,
                 T0=0.55)
    pipe = InferencePipeline(cfg, device=dev)
    perturb_(pipe.score_agent.model, seed=1)
    perturb_(pipe.energy_agent.model, seed=2)
    pts = _clouds(dev, 4, seed=3).cpu().numpy() + np.array([0.0, 0.0, 1.0], np.float32)
    c0 = trace.snapshot()
    eager = pipe.predict(pts)
    c1 = trace.snapshot()
    # one eager request: score and energy encoders, 6 grouped radii each
    assert c1["sa_stage.fused"] - c0["sa_stage.fused"] == 12
    assert c1["sa_stage.plain"] == c0["sa_stage.plain"]
    pipe.freeze()
    trace.drain()
    trace.enable()
    try:
        frozen = pipe.predict(pts)          # captures the sample and energy programs
        records, c2 = trace.drain()
        again = pipe.predict(pts)           # replays them
        _, c3 = trace.drain()
    finally:
        trace.disable()
    for k in eager:
        assert np.array_equal(frozen[k], eager[k]), k
        assert np.array_equal(again[k], eager[k]), k
    caps = {r["attrs"]["kind"]: r["attrs"] for r in records if r["name"] == "frozen.capture"}
    assert caps["sample"]["fused_sa"] == 6 and caps["energy"]["fused_sa"] == 6
    assert c2["sa_stage.plain"] == c1["sa_stage.plain"]
    assert (c3["sa_stage.fused"], c3["sa_stage.plain"]) == (c2["sa_stage.fused"],
                                                            c2["sa_stage.plain"])


def test_score_training_step_runs_the_stages_plain(dev):
    cfg = Config(num_points=N_POINTS, batch_size=4, repeat_num=2)
    agent = PoseAgent(cfg, "score", device=dev)
    perturb_(agent.model, seed=5)
    raw = synthetic_batch(np.random.default_rng(0), bs=4, n_pts=N_POINTS, n_model=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = process_batch(raw, cfg.pose_mode, generator=gen, pts_aug_params=cfg.pts_aug,
                          device=dev)
    c0, launches = trace.snapshot(), sa_stage_cuda.launches
    agent.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    c1 = trace.snapshot()
    assert c1["sa_stage.fused"] == c0["sa_stage.fused"]
    assert c1["sa_stage.plain"] - c0["sa_stage.plain"] == 6
    assert sa_stage_cuda.launches == launches
