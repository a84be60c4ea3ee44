"""Multi-device dry run (counterpart of ``__graft_entry__.py::dryrun_multichip``).

``dryrun_multidevice(n, device)`` starts n spawned workers, one per device
(gloo CPU processes for ``device="cpu"``), joins them in one data-parallel
group and runs, on tiny shapes and inside ``parallel.sharded``:

- a score train step (global BatchNorm statistics, the gradient mean);
- checkpoint save on rank 0, restore on every rank and a resumed step,
  checking that every rank's parameters equal rank 0's;
- K-hypothesis sampling with each rank's rows of the global batch;
- an energy-with-ranking train step on those candidates;
- ``InferencePipeline.predict`` under the group, then the frozen pipeline's
  ``predict`` against it (rtol/atol 2e-4, quaternions up to sign).

It is callable from a plain interpreter:

    python -m genpose_tpu_torch.tools.dryrun_multi --num_devices 2 --device cpu

and returns rank 0's summary (the losses and the serving output's shape).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import load_checkpoint, save_checkpoint
from genpose_tpu_torch.utils.weights import perturb_


def _global_batch(bs: int, n_pts: int, seed: int = 0):
    """A zero-centred batch of ``bs`` clouds, the same on every rank."""
    rng = np.random.default_rng(seed)
    center = rng.normal(size=(bs, 3)).astype(np.float32) * 0.01
    gt = rng.normal(size=(bs, 9)).astype(np.float32)
    gt_pose = gt.copy()
    gt_pose[:, -3:] += center
    return {"zero_mean_pts": rng.normal(size=(bs, n_pts, 3)).astype(np.float32) * 0.1,
            "zero_mean_gt_pose": gt, "gt_pose": gt_pose, "pts_center": center,
            "id": np.zeros((bs,), np.int32), "handle_visibility": np.ones((bs,), np.int32)}


def _same_as_rank0(group, agent) -> bool:
    flat = torch.cat([p.detach().reshape(-1) for p in agent.model.parameters()])
    ref = parallel.broadcast_(flat.clone(), group)
    return bool(torch.equal(ref, flat))


def _finite(*xs) -> bool:
    return all(bool(torch.isfinite(torch.as_tensor(x)).all()) for x in xs)


def _dryrun_impl(group: parallel.DPGroup, ckpt_dir: str) -> dict:
    dev, n = group.device, group.world
    bs = 2 * n
    cfg = Config(num_points=64, repeat_num=2, sampling_steps=4, batch_size=bs,
                 eval_repeat_num=2, T0=0.55)
    agent = PoseAgent(cfg, "score", device=dev, steps_per_epoch=4)
    # non-zero heads: the seeded init has zero tail outputs
    perturb_(agent.model, seed=42)
    parallel.replicate(group, agent)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _global_batch(bs, 64).items()}
    batch = parallel.shard_batch(group, batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    with parallel.sharded(group):
        loss = parallel.mean_over_ranks(agent.train_step(batch, gen), group)["gf"]
    assert _finite(loss), f"non-finite score loss {loss}"

    # checkpoint save (rank 0) -> restore (every rank) -> resumed step
    if group.is_writer:
        path = save_checkpoint(ckpt_dir, agent, epoch=0)
    parallel.barrier(group)
    path = os.path.join(ckpt_dir, "ckpt_epoch0")
    load_checkpoint(path, agent, load_model_only=False)
    parallel.replicate(group, agent)
    assert _same_as_rank0(group, agent), "a rank's restored params differ from rank 0's"
    with parallel.sharded(group):
        resumed = agent.train_step(batch, gen)["gf"]
        assert _finite(resumed)
        assert _same_as_rank0(group, agent), "a rank's params drifted after the resumed step"

        # K-hypothesis sampling over this rank's rows
        pred = agent.sample(batch, generator=gen, repeat_num=2, sampler="ode", num_steps=4)
        assert pred.shape == (bs // n, 2, 9), pred.shape

        # energy + ranking step on the candidates
        energy_agent = PoseAgent(cfg, "energy", device=dev, steps_per_epoch=4)
        perturb_(energy_agent.model, seed=43)
        parallel.replicate(group, energy_agent)
        e = parallel.mean_over_ranks(energy_agent.train_step_energy(batch, pred, gen), group)
    assert _finite(e["gf"], e["ranking"]), e

    # the serving pipeline under the group, then its frozen programs
    pipe = InferencePipeline(cfg, batch_size=bs, group=group)
    perturb_(pipe.score_agent.model, seed=42)
    perturb_(pipe.energy_agent.model, seed=43)
    pts = np.random.default_rng(3).normal(size=(bs, cfg.num_points, 3)).astype(np.float32)
    out = pipe.predict(pts * 0.1)
    assert out["pred_pose"].shape == (bs, 7) and np.all(np.isfinite(out["pred_pose"]))
    frozen = pipe.freeze().predict(pts * 0.1)
    sign = np.where(np.sum(frozen["pred_pose"][:, :4] * out["pred_pose"][:, :4], -1,
                           keepdims=True) < 0, -1.0, 1.0)
    q = frozen["pred_pose"].copy()
    q[:, :4] *= sign
    assert np.allclose(q, out["pred_pose"], rtol=2e-4, atol=2e-4), "frozen != eager"
    summary = {"world": n, "score_loss": float(loss), "resumed_loss": float(resumed),
               "energy_loss": float(e["gf"]), "ranking_loss": float(e["ranking"]),
               "serving_pred": tuple(out["pred_pose"].shape)}
    if group.is_writer:
        print(f"dryrun_multidevice({n}) ok: {summary}", flush=True)
    return summary


def dryrun_multidevice(n: int, device="cuda") -> dict:
    """The dry run on ``n`` devices (spawned workers, one group); returns
    rank 0's summary.  Raises if a rank fails or the devices are missing."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        return parallel.launch(_dryrun_impl, n, device, args=(ckpt_dir,))[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_devices", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multidevice(args.num_devices, args.device)


if __name__ == "__main__":
    main()
