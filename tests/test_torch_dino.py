"""GenPose++'s image path in the port (``pts_encoder="dinov2_pointnet2"``):
the frozen DINOv2 ViT-S/14 tower, the lifting of its patch features to the
points and the wide PointNet++ stage 0, against the benchmark's plain
reference (``portbench/reference/genpose_dino_ref.py``) on the CPU at a
small size: 2 blocks, 56-px crops, 64 points, seeded weights.

Tolerances: both sides compute in IEEE float32 and differ in the order of
their sums (GEMM blocking, LayerNorm and softmax reductions, the bilinear
weights computed from 2u/S - 1 or u/14 - 1/2), a few 1e-7 of a value's
scale a layer.  The tower and the lifting are held to 1e-5 of the largest
output; the heads as the benchmark's reference tests hold GenPose's
(``portbench/tests/test_portbench_reference.py``: ``rtol`` 1e-5); the
training step to that file's bounds for a tiny CPU batch, whose train-mode
BatchNorm statistics over a few points amplify float32 noise (loss 1e-4,
gradient 0.1, change 0.2 of the reference's).  A point at a patch centre
reads that patch's token bit for bit.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "portbench"))

from harness import check, common  # noqa: E402
from reference import genpose_dino_ref as dref  # noqa: E402

from genpose_tpu_torch.config import Config  # noqa: E402
from genpose_tpu_torch.data.process import process_batch  # noqa: E402
from genpose_tpu_torch.models.posenet import build_model  # noqa: E402
from genpose_tpu_torch.models.vit import ImageTower, lift_features, normalize_crops  # noqa: E402
from genpose_tpu_torch.training.agent import PoseAgent  # noqa: E402

CPU = torch.device("cpu")
DEPTH, CROP, N, B = 2, 56, 64, 4
CONFIG = json.loads((ROOT / "portbench" / "configs" / "genpose_dino_light.json").read_text())
TOL = 1e-5   # of the largest |output|: float32 sums in two orders (module docstring)


def _cfg(**kw):
    return Config(pts_encoder="dinov2_pointnet2", num_points=N, batch_size=B, mini_bs=B,
                  repeat_num=2, **kw)


def _weights(seed):
    return {**common.make_weights(dref.net_spec(CONFIG["encoder_stages"]), CPU, seed),
            **dref.tower_weights(dref.tower_spec(DEPTH, CROP), CPU, seed + 1)}


def _agent(mode, w):
    """A port agent whose tower is cut to the test's size, with weights ``w``."""
    agent = PoseAgent(_cfg(), mode, device="cpu")
    agent.model.image_tower = ImageTower(DEPTH, CROP)
    common.load_weights(agent, w)
    return agent


def _raw(seed=0):
    """A raw batch as the benchmark's crops come: clouds in front of the
    camera, uint8 crops, and pixels over the whole crop (the border held
    beyond the outermost patch centres)."""
    g = np.random.default_rng(seed)
    pts = g.normal(size=(B, N, 3)).astype(np.float32) * [0.04, 0.03, 0.05]
    R = np.linalg.qr(g.normal(size=(B, 3, 3)))[0].astype(np.float32)
    return {"pcl_in": (pts + [0.0, 0.0, 1.0]).astype(np.float32), "rotation": R,
            "translation": np.tile(np.float32([0.0, 0.0, 1.0]), (B, 1)),
            "cat_id": np.arange(B, dtype=np.int32) % 6,
            "handle_visibility": np.ones(B, np.int32),
            "rgb": g.integers(0, 256, (B, CROP, CROP, 3)).astype(np.uint8),
            "pix": g.uniform(0.0, CROP, (B, N, 2)).astype(np.float32)}


@pytest.fixture(scope="module")
def w():
    return _weights(2**33 + 21)


@pytest.fixture(scope="module")
def batch():
    return process_batch(_raw(), device="cpu")


def _close(got, want, tol=TOL):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, float((got - want).abs().max()) / scale


def test_tower_and_crop_normalisation_match_the_reference(w, batch):
    raw = _raw()
    rgb = torch.as_tensor(raw["rgb"])
    _close(normalize_crops(rgb), dref.normalize(rgb), 1e-6)
    tower = ImageTower(DEPTH, CROP)
    tower.load_state_dict({k[len("image_tower."):]: v for k, v in w.items()
                           if k.startswith("image_tower.")})
    with torch.no_grad():
        got = tower(normalize_crops(batch["rgb"]))
    assert got.shape == (B, 384, CROP // 14, CROP // 14)
    _close(got, dref.DinoRef(CONFIG).tower(w, dref.normalize(rgb)))


def test_a_patch_centre_reads_its_token_and_the_lifting_matches_the_reference():
    g = torch.Generator().manual_seed(3)
    grid = torch.randn(2, 384, 4, 4, generator=g)
    i, j = torch.meshgrid(torch.arange(4), torch.arange(4), indexing="xy")
    centres = torch.stack([14.0 * i + 7, 14.0 * j + 7], -1).reshape(1, 16, 2).expand(2, -1, -1)
    got = lift_features(grid, centres, CROP)
    assert torch.equal(got, grid.reshape(2, 384, 16).transpose(1, 2))
    pix = torch.rand(2, 200, 2, generator=g) * 70 - 7          # inside, beyond the centres, outside
    _close(lift_features(grid, pix, CROP), dref.bilinear(grid, pix))


def test_score_energy_and_sampling_match_the_reference(w, batch):
    score, energy = _agent("score", w), _agent("energy", w)
    r = dref.DinoRef(CONFIG)
    zm, center = batch["zero_mean_pts"], batch["pts_center"]
    feats = score.image_features(batch["rgb"], batch["pix"])
    _close(feats, r.features(w, torch.as_tensor(_raw()["rgb"]), batch["pix"]))
    geo = r.geometry(zm)
    with torch.no_grad():
        feat = score._encode(zm, train=False, features=feats)
        want = r.encode(w, zm, geo, feats=feats)
        torch.testing.assert_close(feat, want, rtol=1e-5, atol=1e-6)
        pose = torch.randn(B, 9, generator=torch.Generator().manual_seed(4))
        t = torch.full((B, 1), 0.3)
        got = score.model.score_with(score.model.precompute_head(feat), pose, t)
        torch.testing.assert_close(got, r.score(w, r.projection(w, want), pose, t),
                                   rtol=1e-5, atol=1e-5)
    K, steps, T0 = 3, 6, 0.55
    gen = torch.Generator().manual_seed(5)
    hyp = score.sample(batch, generator=gen, repeat_num=K, num_steps=steps, T0=T0)
    z = torch.randn(B * K, 9, generator=torch.Generator().manual_seed(5))
    hyp_ref, geo, zm_ref, center_ref = r.sample(w, batch["pts"], feats, z, K, steps, T0)
    torch.testing.assert_close(hyp, hyp_ref, rtol=1e-4, atol=1e-5)
    e = energy.get_energy(batch, hyp, T=1e-5)
    torch.testing.assert_close(e, r.energies(w, zm_ref, center_ref, hyp, feats, geo),
                               rtol=1e-4, atol=1e-4)


def test_a_training_step_matches_the_reference_and_leaves_the_tower_alone(w, batch):
    batch = dict(batch)      # the step leaves its lifted features in the batch
    agent = _agent("score", w)
    tower_before = {k: v.clone() for k, v in agent.model.image_tower.state_dict().items()}
    g = torch.Generator().manual_seed(6)
    noises = [(torch.rand(2, B, 1, generator=g) * 0.9 + 0.1, torch.randn(2, B, 9, generator=g))
              for _ in range(2)]     # two steps: the first one's learning rate is 0 (warm-up)
    losses, grads = [], None
    for noise in noises:
        losses.append(float(agent.train_step(batch, noise=noise)["gf"]))
        grads = grads or {k: v / (1 - 0.9) for k, v in agent.state.opt_state["mu"].items()}
    # the tower: buffers only, no step, no moment, no shadow, unchanged
    assert not any(k.startswith("image_tower") for k in agent.params())
    assert not any(k.startswith("image_tower") for k in agent.state.opt_state["mu"])
    assert not any(k.startswith("image_tower") for k in agent.state.ema.shadow)
    for k, v in agent.model.image_tower.state_dict().items():
        assert torch.equal(v, tower_before[k]) and not v.requires_grad
    params = {k: p.detach() for k, p in agent.params().items()}
    r = dref.DinoRef(CONFIG)
    feats = r.features(w, torch.as_tensor(_raw()["rgb"]), batch["pix"])
    clouds = [(torch.cat([batch["zero_mean_pts"], feats], -1), batch["zero_mean_gt_pose"])]
    hp = {"lr": 1e-3, "warmup": 100, "lr_decay": 0.98, "lr_floor": 1e-4,
          "steps_per_epoch": 1000, "grad_clip": 1.0, "ema": 0.999}
    got = r.train(w, clouds * 2, noises, hp)
    n = check.train_numbers(losses, grads, params, agent.state.ema.shadow, *got, w)
    assert n["loss_gap"] < 1e-4 and n["grad_gap"] < 0.1 and n["change_gap"] < 0.2, n
    # without the features the step is another step
    zeroed = r.train(w, [(torch.cat([batch["zero_mean_pts"], feats * 0], -1),
                          batch["zero_mean_gt_pose"])] * 2, noises, hp)
    assert check.train_numbers(*zeroed, *got, w)["loss_gap"] > 10 * max(n["loss_gap"], 1e-7)


def test_the_tower_runs_once_a_step_for_the_step_and_its_ema_loss(w, batch):
    """``train_step`` leaves the batch's lifted features in it; the EMA loss
    of the same batch reads them and runs no tower, and its loss equals the
    one from features made afresh.  A distillation step's teacher reads the
    student's."""
    from genpose_tpu_torch.utils import trace

    agent, batch = _agent("score", w), dict(batch)
    g = torch.Generator().manual_seed(7)
    noise = (torch.rand(2, B, 1, generator=g) * 0.9 + 0.1, torch.randn(2, B, 9, generator=g))
    before = trace.snapshot()["image_tower.crops"]
    agent.train_step(batch, noise=noise)
    reused = agent.ema_loss(batch, noise=noise)
    assert trace.snapshot()["image_tower.crops"] - before == B
    assert torch.equal(batch["features"], agent.image_features(batch["rgb"], batch["pix"]))
    fresh = agent.ema_loss({k: v for k, v in batch.items() if k != "features"}, noise=noise)
    assert torch.equal(reused, fresh)
    # a distillation step runs one tower for the student and its teacher
    student, batch = _agent("energy", w), {k: v for k, v in batch.items() if k != "features"}
    before = trace.snapshot()["image_tower.crops"]
    student.train_step_distill(agent, batch, noise=noise)
    assert trace.snapshot()["image_tower.crops"] - before == B and "features" in batch


def test_frozen_equals_eager_and_the_pipeline_serves_crops(w):
    from genpose_tpu_torch.runners.serving import InferencePipeline

    raw = _raw(1)
    pipe = InferencePipeline(_cfg(eval_repeat_num=3, sampling_steps=4), device="cpu")
    for agent in (pipe.score_agent, pipe.energy_agent):
        agent.model.image_tower = ImageTower(DEPTH, CROP)
        common.load_weights(agent, w)
    out = pipe.predict(raw["pcl_in"][:3], torch.Generator().manual_seed(8), rgb=raw["rgb"][:3],
                       pix=raw["pix"][:3])
    frozen = pipe.freeze().predict(raw["pcl_in"][:3], torch.Generator().manual_seed(8),
                                   rgb=raw["rgb"][:3], pix=raw["pix"][:3])
    assert out["pred_pose"].shape == (3, 7)
    for k in out:
        np.testing.assert_array_equal(out[k], frozen[k])
    with pytest.raises(ValueError, match="takes rgb and pix"):
        pipe.predict(raw["pcl_in"])


def test_build_model_takes_dinov2_pointnet2_and_still_refuses_unknown_values():
    model = build_model(_cfg(), "energy", device="cpu")
    assert model.encoder.sa_0.mlp_0.dense_0.weight.shape == (16, 387)
    assert model.encoder.sa_0.mlp_1.dense_0.weight.shape == (32, 387)
    assert model.encoder.sa_1.mlp_0.dense_0.weight.shape == (64, 99)
    assert model.image_tower.pos_embed.shape == (1, 257, 384)
    assert len(model.image_tower.blocks) == 12
    assert not any(n.startswith("image_tower") for n, _ in model.named_parameters())
    for cfg in (Config(pts_encoder="pointnet3"), Config(pointnet2_params="huge"),
                _cfg(pointnet2_params="huge")):
        with pytest.raises((NotImplementedError, KeyError)):
            build_model(cfg, "score", device="cpu")


def test_features_reach_only_the_encoder_that_takes_them(batch):
    """``pointnet2`` refuses features, ``dinov2_pointnet2`` needs them; a
    batch without crops keeps the keys it had; the NOCS loader, which cuts
    no crops, refuses the encoder."""
    from genpose_tpu_torch.data.loader import get_data_loaders_from_cfg

    plain = build_model(Config(num_points=N), "score", device="cpu")
    with pytest.raises(ValueError, match="takes no image features"):
        plain.encode_pts(batch["zero_mean_pts"], features=torch.zeros(B, N, 384))
    with pytest.raises(ValueError, match="takes lifted image features"):
        build_model(_cfg(), "score", device="cpu").encode_pts(batch["zero_mean_pts"])
    raw = {k: v for k, v in _raw().items() if k not in ("rgb", "pix")}
    assert set(process_batch(raw, device="cpu")) == set(batch) - {"rgb", "pix"}
    with pytest.raises(NotImplementedError, match="cuts no RGB crops"):
        get_data_loaders_from_cfg(_cfg(data_path="unread"), ["train"])
