"""The reference held against the port's eager outputs on the CPU at tiny
sizes: a test of the copy, not of the port.  Both encoders, Heun serving,
the 3D augmentation and a training step."""

import time

import numpy as np
import pytest
import torch

from conftest import SMALL
from harness import common, traffic as gen
from harness.cellrun import run_cell
from reference import genpose_ref as ref

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["genpose_light", "genpose_full"])
def test_encoders_agree(name):
    from genpose_tpu_torch.models.posenet import build_model

    config = common.load("configs", name)
    model = build_model(common.port_config(config), "score", device="cpu")
    w = common.make_weights(ref.param_spec(config["encoder_stages"]), CPU, 11)
    w = {k: w[k] + 0.1 * torch.randn(w[k].shape, generator=torch.Generator().manual_seed(1))
         if k.endswith(("running_mean", "bn_0.bias")) else w[k] for k in w}
    sd = dict(w)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    pts = torch.randn(3, 128, 3) * 0.05
    pts = pts - pts.mean(1, keepdim=True)
    r = ref.Ref(config)
    with torch.no_grad():
        got = model.encode_pts(pts)
    want = r.encode(w, pts, r.geometry(pts))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_served_poses_and_energies_agree():
    out = run_cell("genpose_light.eval_b256", 2**33 + 9, 0.2, False, CPU, time.perf_counter(),
                   SMALL["serve"])
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["pose_gap"] < 1e-5 and out["numbers"]["energy_gap"] < 1e-5


@pytest.mark.parametrize("flags", ["each", "none", "drawn"])
def test_the_augmentation_agrees(flags):
    """The port's batch preparation with its 3D augmentation against the
    reference's copy, on the same raw batch and draws: every change made
    (bowls and mugs caged), none, and as the draws fall."""
    from genpose_tpu_torch.config import PtsAugConfig
    from genpose_tpu_torch.data.process import process_batch

    traffic = {**common.load("traffic", "train_b192"), "batch": 12, "points": 64, "pool": 1}
    raw = gen.train_batches(traffic, 2**33 + 11, CPU)[0]
    raw["cat_id"] = np.arange(12, dtype=np.int32) % 6
    draws = gen.augment_draws(common.generator(CPU, 5), traffic, CPU)
    if flags != "drawn":
        for k in ("bb", "rt", "bc", "pc"):
            draws[k] = torch.full_like(draws[k], 0.0 if flags == "each" else 1.0)
    got = process_batch(raw, "rot_matrix", pts_aug_params=PtsAugConfig(**traffic["pts_aug"]),
                        device="cpu", draws=draws)
    pts, R, t = ref.augment(traffic["pts_aug"], {k: torch.as_tensor(v) for k, v in raw.items()},
                            draws)
    center = pts.mean(1)
    torch.testing.assert_close(got["zero_mean_pts"], pts - center[:, None], rtol=0, atol=2e-6)
    torch.testing.assert_close(got["zero_mean_gt_pose"],
                               torch.cat([R[..., 0], R[..., 1], t - center], -1),
                               rtol=0, atol=2e-6)
    moved = (got["pts"] - torch.as_tensor(raw["pcl_in"])).abs().amax((1, 2))
    assert bool((moved > 1e-4).all()) if flags == "each" else True
    assert float(moved.max()) == 0.0 if flags == "none" else True


@pytest.mark.parametrize("cell", ["genpose_light.train_b192", "genpose_full.train_b192"])
def test_training_steps_agree(cell):
    """Three steps of the port's agent against the reference's three: the
    losses to float32 noise; the gradient and the changes within the few
    per cent that train-mode BatchNorm over a tiny CPU batch leaves."""
    out = run_cell(cell, 2**33 + 10, 0.2, False, CPU, time.perf_counter(), SMALL["train"])
    n = out["numbers"]
    assert n["loss_gap"] < 1e-4 and n["grad_gap"] < 0.1 and n["change_gap"] < 0.2, n
