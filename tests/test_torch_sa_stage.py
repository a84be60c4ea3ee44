"""Which grouped SA stages take the eval-mode kernel (``ops/sa_stage_cuda.py``).

``PointnetSAModuleMSG.forward`` routes on what its inputs show
(``models/pointnet2.py::fused_sa_applies``).  Here, on the CPU, the card is
simulated (``pointnet2._on_card`` reads True) and the kernel replaced by a
spy that writes the plain arithmetic into the radius' columns, so each
condition is tested alone:

- float32 grouped stages in eval mode without autograd: the kernel, one
  call a radius, the light stages 0-2 (6 radii) of an encoder pass;
- train mode, grad enabled, a bfloat16 stage, bfloat16 grouped
  coordinates, CPU tensors, the GroupAll stage and a width without an
  instantiation (387 = 3 + 384 image features): the plain arithmetic, bit
  for bit what the stage computed before the kernel existed;
- a score training step runs its stages plain; the EMA loss (eval mode, no
  grad) takes the kernel;
- the counters ``sa_stage.fused`` / ``sa_stage.plain`` count the radii of
  each path; the wrapper refuses CPU tensors and shapes it has no
  instantiation for.

The kernel itself is held against the plain arithmetic on the card in
``tests/test_torch_sa_stage_cuda.py``.
"""

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.models import pointnet2
from genpose_tpu_torch.ops import sa_stage_cuda
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.weights import perturb_

B, N = 2, 1024


@pytest.fixture
def card(monkeypatch):
    """A simulated card: every tensor reads as a CUDA tensor to the router,
    and the kernel is a spy that writes the plain arithmetic into ``out``.
    Yields the spy's calls (nsample, input features, column)."""
    calls = []

    def spy(mlp, grouped_xyz, features, gidx, out, col0):
        c = 0 if features is None else features.shape[-1]
        calls.append((gidx.shape[-1], c, col0))
        ref = sa_stage_cuda.sa_stage_ref(mlp, grouped_xyz, features, gidx)
        out[..., col0:col0 + ref.shape[-1]] = ref
        return out

    monkeypatch.setattr(pointnet2, "_on_card", lambda x: True)
    monkeypatch.setattr(sa_stage_cuda, "sa_stage", spy)
    return calls


def _plain(monkeypatch):
    """Route every stage plain (the real router on CPU tensors)."""
    monkeypatch.setattr(pointnet2, "_on_card", lambda x: x.is_cuda)


@pytest.fixture(scope="module")
def cloud():
    g = torch.Generator().manual_seed(0)
    d = torch.randn(B, N, 3, generator=g)
    return (d / d.norm(dim=-1, keepdim=True) * torch.tensor([0.1, 0.06, 0.04])).contiguous()


def _encoder(seed=0, **kw):
    enc = perturb_(pointnet2.Pointnet2ClsMSG("light", **kw), seed=seed, scale=0.05)
    return enc.eval().requires_grad_(False)


def _counts():
    snap = trace.snapshot()
    return snap["sa_stage.fused"], snap["sa_stage.plain"]


def test_an_eval_encoder_pass_takes_the_kernel_for_stages_0_to_2(card, monkeypatch, cloud):
    enc = _encoder()
    geoms = pointnet2.cls_msg_geometry(cloud, "light")
    f0, p0 = _counts()
    with torch.no_grad():
        got = enc(cloud, geometry=geoms)
    assert card == [(16, 0, 0), (32, 0, 32), (16, 96, 0), (32, 96, 128), (16, 256, 0),
                    (32, 256, 256)]
    assert _counts() == (f0 + 6, p0)  # GroupAll (stage 3) counts on neither path
    _plain(monkeypatch)
    with torch.no_grad():
        want = enc(cloud, geometry=geoms)
    assert _counts() == (f0 + 6, p0 + 6)
    assert torch.equal(got, want)


def _stage_case(cloud, k=1, **kw):
    """(stage, geometry, input features) of the light encoder's stage k, its
    input from the plain arithmetic of the stages before it."""
    enc = _encoder(**kw)
    geoms = pointnet2.cls_msg_geometry(cloud, "light", dtype=kw.get("dtype", torch.float32))
    feats = None
    with torch.no_grad():
        for j in range(k):
            sa = getattr(enc, f"sa_{j}")
            feats = torch.cat([sa_stage_cuda.sa_stage_ref(getattr(sa, f"mlp_{i}"),
                                                          geoms[j]["grouped_xyz"][i], feats,
                                                          geoms[j]["gidx"][i])
                               for i in range(sa.n_scales)], dim=-1)
    return getattr(enc, f"sa_{k}"), geoms[k], feats


def _bypass_train_mode(cloud, monkeypatch):
    sa, geom, feats = _stage_case(cloud)
    return sa.train(), geom, feats, torch.no_grad


def _bypass_grad(cloud, monkeypatch):
    return (*_stage_case(cloud), torch.enable_grad)


def _bypass_bf16_stage(cloud, monkeypatch):
    return (*_stage_case(cloud, dtype=torch.bfloat16), torch.no_grad)


def _bypass_bf16_coordinates(cloud, monkeypatch):
    """A float32 stage 0 whose grouped coordinates are bfloat16."""
    sa, _, feats = _stage_case(cloud, k=0, geometry_dtype=torch.bfloat16)
    geom = pointnet2.cls_msg_geometry(cloud, "light", dtype=torch.bfloat16)[0]
    return sa, geom, feats, torch.no_grad


def _bypass_cpu(cloud, monkeypatch):
    _plain(monkeypatch)
    return (*_stage_case(cloud), torch.no_grad)


def _bypass_group_all(cloud, monkeypatch):
    return (*_stage_case(cloud, k=3), torch.no_grad)


def _bypass_unknown_width(cloud, monkeypatch):
    """Stage 0 over [dxyz ; 384 image features]: 387 inputs."""
    enc = _encoder(in_features=384)
    geom = pointnet2.cls_msg_geometry(cloud, "light")[0]
    feats = torch.randn(B, N, 384, generator=torch.Generator().manual_seed(3))
    return enc.sa_0, geom, feats, torch.no_grad


@pytest.mark.parametrize("case", [_bypass_train_mode, _bypass_grad, _bypass_bf16_stage,
                                  _bypass_bf16_coordinates, _bypass_cpu, _bypass_group_all,
                                  _bypass_unknown_width],
                         ids=["train_mode", "grad_enabled", "bfloat16_stage",
                              "bfloat16_coordinates", "cpu_tensors", "group_all",
                              "width_387"])
def test_each_bypass_runs_the_plain_arithmetic(card, monkeypatch, cloud, case):
    sa, geom, feats, mode = case(cloud, monkeypatch)
    f0, p0 = _counts()
    with mode():
        _, got = sa(None, feats, geometry=geom)
    assert card == []
    grouped = sa.npoint is not None
    assert _counts() == (f0, p0 + (sa.n_scales if grouped else 0))
    # the stage's arithmetic before the kernel existed
    outs = []
    with mode():
        for i in range(sa.n_scales):
            gx = geom["grouped_xyz"][i]
            if feats is None:
                g = gx
            elif grouped:
                g = torch.cat([gx, pointnet2.group_points(feats, geom["gidx"][i])], dim=-1)
            else:
                g = torch.cat([gx, feats[:, None]], dim=-1)
            outs.append(torch.amax(getattr(sa, f"mlp_{i}")(g), dim=2))
        want = torch.cat(outs, dim=-1)
    assert torch.equal(got, want)


def test_training_runs_the_stages_plain_and_the_ema_loss_takes_the_kernel(card):
    cfg = Config(num_points=64, batch_size=4, repeat_num=2)
    agent = PoseAgent(cfg, "score", device="cpu")
    perturb_(agent.model, seed=5)
    raw = synthetic_batch(np.random.default_rng(0), bs=4, n_pts=64, n_model=128)
    gen = torch.Generator().manual_seed(0)
    batch = process_batch(raw, cfg.pose_mode, generator=gen, pts_aug_params=cfg.pts_aug,
                          device="cpu")
    f0, p0 = _counts()
    agent.train_step(batch, generator=gen)
    assert card == [] and _counts() == (f0, p0 + 6)
    agent.ema_loss(batch, generator=gen)
    assert len(card) == 6 and _counts() == (f0 + 6, p0 + 6)


def test_the_wrapper_refuses_cpu_tensors_and_unknown_shapes(cloud):
    enc = _encoder()
    geom = pointnet2.cls_msg_geometry(cloud, "light")[0]
    out = torch.empty(B, 512, 96)
    with pytest.raises(ValueError, match="CUDA"):
        sa_stage_cuda.sa_stage(enc.sa_0.mlp_0, geom["grouped_xyz"][0], None, geom["gidx"][0],
                               out, 0)
    assert not sa_stage_cuda.has_instantiation(16, 384, _encoder(in_features=384).sa_0.mlp_0)
    assert sa_stage_cuda.has_instantiation(32, 256, enc.sa_2.mlp_1)
