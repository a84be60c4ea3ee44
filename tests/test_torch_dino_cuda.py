"""GenPose++'s image path (``pts_encoder="dinov2_pointnet2"``) served on the
card through the frozen ``InferencePipeline``, at the benchmark's widths.

Marked ``cuda``: skips without an NVIDIA GPU (decided in the fixture).  The
card's machine has no JAX: run
``python -m pytest --noconftest -m cuda tests/test_torch_dino_cuda.py``.

- Frozen equals eager bit for bit: a request of 256 clouds with their
  crops served eagerly, then by the frozen pipeline (the tower and the
  lifting run before the captured programs, as the geometry does).
- The tower runs once a request, for both nets (``image_tower.crops``).
- Two requests of 256 clouds with crops (K=50, Heun-500 from T0=0.55,
  the top 60% pooled) against ``portbench/reference/genpose_dino_ref.py``
  on the same clouds, crops, weights and prior draws: ``pose_gap`` and
  ``energy_gap`` (``portbench/harness/check.py::serve_numbers``) within the
  ``genpose_light.eval_b256`` cell's limits, 1.2e-4 and 2e-5.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "portbench"))

from harness import check, common, train_rgb, traffic as gen  # noqa: E402
from reference import genpose_dino_ref as dref  # noqa: E402

from genpose_tpu_torch.runners.serving import InferencePipeline  # noqa: E402
from genpose_tpu_torch.utils import trace  # noqa: E402

pytestmark = pytest.mark.cuda

SEED = 3_000_000_777
CONFIG = common.load("configs", "genpose_dino_light")
SERVE = common.load("traffic", "eval_b256")
CROP = common.load("traffic", "train_rgb_b192")["crop"]
LIMITS = common.load("cells", "genpose_light.eval_b256")["limits"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _weights(dev):
    """The score and energy nets' weights: one tower, as in a deployment
    (the pipeline runs the score net's tower for both)."""
    score = train_rgb.weights(CONFIG, dev, SEED)
    energy = train_rgb.weights(CONFIG, dev, SEED + 1)
    return score, {**energy, **{k: v for k, v in score.items() if k.startswith("image_tower.")}}


def _request(i, dev):
    """Request i: 256 clouds (camera frame), their crops and pixels."""
    pts = gen.request_clouds(SERVE, SEED, i, dev)
    crops = train_rgb.crop_pool({"crop": CROP}, common.seed_of(SEED, i),
                                [{"pcl_in": pts.cpu().numpy()}], dev)[0]
    return pts, crops


@pytest.fixture(scope="module")
def served(dev):
    cfg = common.port_config(CONFIG, batch_size=SERVE["batch"],
                             eval_repeat_num=SERVE["hypotheses"],
                             sampling_steps=SERVE["steps"], T0=SERVE["T0"],
                             sampler_mode=(SERVE["sampler"],), ratio=SERVE["keep_ratio"])
    pipe = InferencePipeline(cfg, device=dev)
    ws, we = _weights(dev)
    common.load_weights(pipe.score_agent, ws)
    common.load_weights(pipe.energy_agent, we)
    pts, crops = _request(0, dev)
    eager = pipe.predict(pts.cpu().numpy(), common.generator(dev, 1), **crops)
    pipe.freeze().warmup()
    frozen = pipe.predict(pts.cpu().numpy(), common.generator(dev, 1), **crops)
    taps = [common.Tap(pipe.score_agent, "sample"), common.Tap(pipe.energy_agent, "get_energy")]
    before = trace.snapshot()["image_tower.crops"]
    outs = []
    for i in range(2):
        pts, crops = _request(i, dev)
        outs.append(pipe.predict(pts.cpu().numpy(), common.generator(dev, 100 + i), **crops))
    crops_run = trace.snapshot()["image_tower.crops"] - before
    for tap in taps:
        tap.close()
    return {"eager": eager, "frozen": frozen, "outs": outs, "hyps": taps[0].outs,
            "energies": taps[1].outs, "crops_run": crops_run, "weights": (ws, we)}


def test_frozen_equals_eager_bit_for_bit(served):
    for k in served["eager"]:
        np.testing.assert_array_equal(served["eager"][k], served["frozen"][k])


def test_the_tower_runs_once_a_request_for_both_nets(served):
    assert served["crops_run"] == 2 * SERVE["batch"]


def test_served_poses_and_energies_match_the_reference(served, dev):
    r = dref.DinoRef(CONFIG)
    ws, we = served["weights"]
    K, keep = SERVE["hypotheses"], max(1, int(SERVE["keep_ratio"] * SERVE["hypotheses"]))
    nums = []
    for i, out in enumerate(served["outs"]):
        pts, crops = _request(i, dev)
        rgb, pix = (torch.as_tensor(crops[k], device=dev) for k in ("rgb", "pix"))
        feats = r.features(ws, rgb, pix)
        z = torch.randn((SERVE["batch"] * K, 9), generator=common.generator(dev, 100 + i),
                        device=dev)
        hyp_ref, geo, zm, center = r.sample(ws, pts, feats, z, K, SERVE["steps"], SERVE["T0"])
        hyp, energy = served["hyps"][i], served["energies"][i]
        pooled = torch.as_tensor(out["pred_pose"], device=dev)
        e_ref = r.energies(we, zm, center, hyp, feats, geo)
        nums.append(check.serve_numbers(hyp, energy, pooled[:, :4], pooled[:, 4:], keep,
                                        hyp_ref, e_ref))
    got = check.worst(nums)
    print("dino serving check", got)
    assert got["pose_gap"] <= LIMITS["pose_gap"] and got["energy_gap"] <= LIMITS["energy_gap"], got
