"""The check can fail.  The control (the reference in TF32 in the program's
place) reads above the cells' limits, and a run whose timed path is broken
underneath comes out not correct: for every fault the cells can have (a
state left unchanged, half of the batch left out, an answer altered where
it is produced, the augmentation skipped).  The harness runs on the CPU at test sizes, without its
look for a chip."""

import contextlib
import sys
import time

import pytest
import torch

from conftest import PORTBENCH, SMALL
from harness import common
from harness.cellrun import run_cell

sys.path.insert(0, str(PORTBENCH / "tools"))
import control  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**32 + 77
SERVING = [("genpose_light.eval_b256", "serve")]
TRAINING = ["genpose_light.train_b192", "genpose_full.train_b192"]
CONTROL_SMALL = {"serve": dict(batch=4, points=256, hypotheses=10, steps=20),
                 "train": dict(batch=8, points=256, repeat_num=4, pool=3)}


def run(cell, kind):
    return run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter(), SMALL[kind])


@pytest.mark.parametrize("cell,kind", SERVING + [(c, "train") for c in TRAINING])
def test_the_control_fails_a_limit(cell, kind):
    limits = common.load("cells", cell)["limits"]
    got = control.control(cell, SEED, CPU, CONTROL_SMALL[kind], n=2)
    assert any(got["control"][k] > v for k, v in limits.items()), got
    if kind == "train":
        assert got["half_batch"]["loss_gap"] > limits["loss_gap"]
        assert got["aug_skipped"]["aug_gap"] > limits["aug_gap"]
    else:
        for fault in ("half_batch", "answer_altered"):
            assert got[fault]["pose_gap"] > limits["pose_gap"], (fault, got)


@contextlib.contextmanager
def patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def half_batch_sample(old):
    """The sampler serves the first half of the clouds and hands their
    hypotheses to the rest."""
    def sample(self, batch, *args, **kwargs):
        out = old(self, batch, *args, **kwargs)
        n = out.shape[0]
        return torch.cat([out[:n - n // 2], out[:n // 2]])
    return sample


def altered_pool(old):
    """The first pooled pose moved by a centimetre where it is produced."""
    def aggregate(self, pred_pose):
        q, avg = old(self, pred_pose)
        avg = avg.clone()
        avg[0, -3:] += 0.01
        return q, avg
    return aggregate


@pytest.mark.parametrize("cell,kind", SERVING)
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_a_broken_serving_path_is_not_correct(cell, kind, fault):
    from genpose_tpu_torch.training.agent import PoseAgent

    assert run(cell, kind)["result"]["correct"]
    name, make = {"half_batch": ("sample", half_batch_sample),
                  "answer_altered": ("aggregate_hypotheses", altered_pool)}[fault]
    with patched(PoseAgent, name, make):
        out = run(cell, kind)
    assert not out["result"]["correct"], out["numbers"]


def unchanged_state(old):
    def apply_gradients(self, params, grads):
        before = {k: p.detach().clone() for k, p in params.items()}
        old(self, params, grads)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(before[k])
    return apply_gradients


def half_batch_step(old):
    """The step's loss is the mean over the first half of the batch."""
    def train_step(self, batch, generator=None, noise=None):
        h = batch["zero_mean_pts"].shape[0] // 2
        batch = {k: v[:h] for k, v in batch.items()}
        return old(self, batch, generator, (noise[0][:, :h], noise[1][:, :h]))
    return train_step


def skipped_augmentation(old):
    """The batch prepared without the 3D augmentation."""
    def process_batch(*args, **kwargs):
        return old(*args, **{**kwargs, "pts_aug_params": None})
    return process_batch


@pytest.mark.parametrize("cell", TRAINING)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "augmentation_skipped"])
def test_a_broken_training_step_is_not_correct(cell, fault):
    from genpose_tpu_torch.data import process
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.state import TrainState

    sound = run(cell, "train")["numbers"]
    owner, name, make = {"unchanged_state": (TrainState, "apply_gradients", unchanged_state),
                         "half_batch": (PoseAgent, "train_step", half_batch_step),
                         "augmentation_skipped": (process, "process_batch",
                                                  skipped_augmentation)}[fault]
    with patched(owner, name, make):
        out = run(cell, "train")
    assert not out["result"]["correct"]
    assert max(out["numbers"][k] / max(sound[k], 1e-12) for k in sound) > 10, (sound, out)
