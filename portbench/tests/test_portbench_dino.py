"""The cell ``genpose_dino_light.train_rgb_b192`` (GenPose++'s image path)
on the CPU at test sizes: its files are found by name, every crop pixel
lies inside its crop, the reference refuses what it does not compute, the
readers of its per-layer metrics read the driver's spans, the program
agrees with the reference, and the control and the faults fail the cell's
limits (the control at the CPU's test size; the card's readings set the
limits, PERF.md section 2)."""

import contextlib
import sys
import time

import pytest
import torch

from conftest import PORTBENCH
from harness import cellrun, common, traffic as gen, train_rgb, work
from harness.cellrun import RunView, run_cell
from reference import genpose_dino_ref as dref

sys.path.insert(0, str(PORTBENCH / "tools"))
import control  # noqa: E402

CPU = torch.device("cpu")
CELL = "genpose_dino_light.train_rgb_b192"
SEED = 2**32 + 91
SMALL = dict(batch=4, points=256, repeat_num=2, pool=2, span_units=1, profile_units=1)
CONTROL_SMALL = dict(batch=8, points=256, repeat_num=4, pool=3)


def test_the_cell_is_found_by_name_and_reports_its_metrics():
    cell, config, traffic = common.cell(CELL)
    assert (config["pts_encoder"], config["pointnet2_params"], traffic["kind"]) == (
        "dinov2_pointnet2", "light", "train_rgb")
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap", "ema_gap", "aug_gap"}
    got = cellrun.cell_metrics(CELL, ["train_samples_per_s", "setup_s"])
    assert set(got) == {"optimizer_ms.train", "geometry_roofline.train", "mfu.train",
                        "device_idle.train", "tower_ms.train", "tower_roofline.train",
                        "sa0_roofline.train"}
    assert all(callable(cellrun.metric_reader(m)) for m in got)
    assert not set(cellrun.cell_metrics("genpose_light.train_b192", ["train_samples_per_s"])) & {
        "tower_ms.train", "tower_roofline.train", "sa0_roofline.train"}


def test_every_crop_pixel_lies_inside_its_crop():
    traffic = {**common.load("traffic", "train_rgb_b192"), "batch": 64, "points": 512, "pool": 3}
    pool = gen.train_batches(traffic, SEED, CPU)
    crops = train_rgb.crop_pool(traffic, SEED, pool, CPU)
    S = traffic["crop"]["size"]
    for c in crops:
        assert c["rgb"].shape == (64, S, S, 3) and str(c["rgb"].dtype) == "uint8"
        assert c["pix"].shape == (64, 512, 2)
        assert c["pix"].min() > 0 and c["pix"].max() < S
        span = c["pix"].max(1) - c["pix"].min(1)
        assert abs(span.max(-1) - S / traffic["crop"]["pad"]).max() < 1e-3   # the 1.5x pad


def test_the_reference_refuses_what_it_does_not_compute():
    config = common.load("configs", "genpose_dino_light")
    dref.DinoRef(config)
    with pytest.raises(NotImplementedError):
        dref.DinoRef(common.load("configs", "genpose_light"))
    for key, value in (("num_heads", 12), ("embed_dim", 768), ("registers", 4)):
        with pytest.raises(NotImplementedError):
            dref.DinoRef({**config, "image_tower": {**config["image_tower"], key: value}})
    with pytest.raises(NotImplementedError):
        dref.DinoRef({**config, "energy_mode": "DAE"})


def test_the_readers_read_the_driver_spans_and_nothing_without_them():
    config, traffic = common.load("configs", "genpose_dino_light"), common.load(
        "traffic", "train_rgb_b192")
    ops = train_rgb.tower_ops(config["image_tower"], 1)
    assert abs(ops - 12.25e9) < 0.01e9                       # 12.25 GFLOP a crop
    sa0 = train_rgb.sa0_work(config["encoder_stages"], 192, 1024, 384)
    # the points' features projected once a point, dxyz and the later products once a neighbour
    assert sa0[0] == 2 * 192 * (1024 * 384 * 48 + 512 * (16 * 3 * 16 + 32 * 3 * 32)
                                + 512 * (16 * 16 * 32 + 32 * 32 * 64)
                                + 512 * (16 * 16 * 16 + 32 * 32 * 32))
    assert sa0[1] == 4 * 192 * (1024 * 387 + 512 * 96)       # input read, output written once
    peak = common.PEAKS["H100"]
    train_rgb.SPAN_WORK.update(image_tower=(train_rgb.tower_ops(config["image_tower"], 192), 0),
                               sa0=sa0)
    view = RunView({"image_tower": [70.0, 72.0], "sa0": [8.0], "step": [200.0, 210.0]}, 10,
                   30.0, train_rgb.step_ops(config, traffic), peak, None, None, {})
    read = {m: cellrun.metric_reader(m)(view) for m in
            ("tower_ms.train", "tower_roofline.train", "sa0_roofline.train", "mfu.train")}
    assert read["tower_ms.train"] == 71.0
    assert read["tower_roofline.train"] == pytest.approx(100 * 192 * ops / 67e12 / 0.071)
    assert read["sa0_roofline.train"] == pytest.approx(100 * sa0[0] / 67e12 / 0.008)
    assert 0 < read["mfu.train"] < 100
    # the tower's spans summed over the slice's steps: once a step
    view.spans = {"image_tower": [70.0, 72.0, 71.0], "step": [200.0, 210.0]}
    assert cellrun.metric_reader("tower_ms.train")(view) == 106.5
    # the monitoring loss reads the step's features: no tower in its term
    B, rows, every = traffic["batch"], traffic["batch"] * traffic["repeat_num"], \
        traffic["monitor"]["ema_loss_every"]
    twice = {**traffic, "monitor": {**traffic["monitor"], "ema_loss_every": every / 2}}
    fwd = (B * train_rgb.encoder_ops(config["encoder_stages"], traffic["points"], 384)
           + work.projection_ops(B) + work.head_ops(rows, rows))
    assert (train_rgb.step_ops(config, twice) - train_rgb.step_ops(config, traffic)
            == pytest.approx(fwd / every))
    empty = RunView({}, 10, 30.0, 1.0, peak, None, None, {})
    assert all(cellrun.metric_reader(m)(empty) is None
               for m in ("tower_ms.train", "tower_roofline.train", "sa0_roofline.train"))


def run():
    return run_cell(CELL, SEED, 0.2, False, CPU, time.perf_counter(), SMALL)


def test_the_program_agrees_with_the_reference():
    """Three steps on the CPU at test size, held as
    ``test_portbench_reference.py::test_training_steps_agree`` holds them: a
    tiny batch's BatchNorm statistics amplify float32 noise."""
    n = run()["numbers"]
    assert n["loss_gap"] < 1e-4 and n["grad_gap"] < 0.1 and n["change_gap"] < 0.2, n
    assert n["aug_gap"] < 5e-5, n


@contextlib.contextmanager
def zeroed_features():
    from genpose_tpu_torch.training.agent import PoseAgent

    old = PoseAgent.image_features
    PoseAgent.image_features = lambda self, rgb, pix: torch.zeros(
        *pix.shape[:2], 384, device=pix.device)
    try:
        yield
    finally:
        PoseAgent.image_features = old


def test_a_step_that_skips_the_tower_is_not_correct():
    sound = run()["numbers"]
    with zeroed_features():
        out = run()
    assert not out["result"]["correct"]
    assert max(out["numbers"][k] / max(sound[k], 1e-12) for k in sound) > 10, (sound, out)


def test_the_control_and_the_faults_fail_the_limits():
    limits = common.load("cells", CELL)["limits"]
    got = control.control(CELL, SEED, CPU, CONTROL_SMALL)
    assert any(got["control"][k] > v for k, v in limits.items()), got
    for fault in ("half_batch", "features_zeroed"):
        assert any(got[fault][k] > v for k, v in limits.items()), (fault, got)
    assert got["aug_skipped"]["aug_gap"] > limits["aug_gap"]
