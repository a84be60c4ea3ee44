"""Worker side of ``tests/test_torch_parallel.py``: what each rank of a
port group runs (no JAX here, so spawned workers import only the port).

``run_group(group, spec)`` builds the port's agents from checkpoints the
test wrote, takes this rank's rows of the test's global batch and returns
numpy results; ``run_group(None, spec)`` is the single-process run of the
same, for the world-size-1 reference.  With ``spec["two_pass_batch_norm"]``
train-mode BatchNorm takes its statistics as a group's does
(``global_batch_norm``), also in a group of one, where the port itself
runs ``nn.BatchNorm1d``.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.models import layers
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import load_checkpoint


def _agent(spec, mode):
    agent = PoseAgent(Config(**spec["cfg"]), mode, device="cpu")
    load_checkpoint(spec["ckpt"][mode], agent, load_model_only=False)
    return agent


def _rows(group, x, axis=0):
    """This rank's block of a global numpy array along ``axis``."""
    if group is None:
        return torch.from_numpy(np.ascontiguousarray(x))
    per = x.shape[axis] // group.world
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, np.arange(group.rank * per, (group.rank + 1) * per), axis=axis)))


def _state(agent):
    return {k: v.detach().numpy().copy() for k, v in agent.model.state_dict().items()}


def _pin(agent, noise):
    """The score agent's prior returns the first rows of ``noise`` (the
    global batch's rows; ``local_draw`` keeps this rank's)."""
    agent.sde = dataclasses.replace(
        agent.sde, prior=lambda shape, T=None, generator=None, device=None: torch.from_numpy(
            np.ascontiguousarray(noise[:shape[0]])).to(device))


def _pipeline(spec, group, sampler, pinned):
    cfg = Config(**dict(spec["cfg"], sampler_mode=(sampler,)))
    pipe = InferencePipeline(cfg, device="cpu", group=group,
                             score_ckpt=spec["ckpt"]["serve_score"],
                             energy_ckpt=spec["ckpt"]["serve_energy"])
    if pinned:
        _pin(pipe.score_agent, spec["prior"])
    return pipe


@contextlib.contextmanager
def two_pass_batch_norm(group):
    """Train-mode ``layers.batch_norm`` through ``global_batch_norm`` over
    ``group``, whatever its size."""
    plain = layers.batch_norm

    def two_pass(bn, x):
        if not bn.training:
            return plain(bn, x)
        rows = x.float().reshape(-1, x.shape[-1])
        return layers.global_batch_norm(bn, rows, group).reshape(x.shape).to(x.dtype)

    layers.batch_norm = two_pass
    try:
        yield
    finally:
        layers.batch_norm = plain


def run_group(group, spec) -> dict:
    with (two_pass_batch_norm(group) if spec.get("two_pass_batch_norm")
          else contextlib.nullcontext()):
        return _run_group(group, spec)


def _run_group(group, spec) -> dict:
    out = {}
    batch = {k: _rows(group, v) for k, v in spec["batch"].items()}
    with parallel.sharded(group):
        # (a) score steps with the JAX draws (this rank's rows), then with
        # the generator's draws of the global batch
        for name, draws in (("jax", True), ("gen", False)):
            agent = _agent(spec, "score")
            gen = torch.Generator().manual_seed(11)
            losses = []
            for t, z in spec["dsm_noise"]:
                noise = (_rows(group, t, 1), _rows(group, z, 1)) if draws else None
                step = agent.train_step(batch, gen, noise=noise)
                losses.append(parallel.mean_over_ranks(step, group)["gf"].item())
            out[f"score_{name}_losses"] = np.array(losses)
            out[f"score_{name}_state"] = _state(agent)
        # (b) energy-with-ranking steps on the test's candidates
        agent = _agent(spec, "energy")
        for cands, (t, z), t_int in zip(spec["cands"], spec["energy_noise"], spec["t_int"]):
            step = agent.train_step_energy(batch, _rows(group, cands),
                                           noise=(_rows(group, t, 1), _rows(group, z, 1)),
                                           t_int=_rows(group, t_int))
            step = parallel.mean_over_ranks(step, group)
            out.setdefault("energy_losses", []).append([step["gf"].item(),
                                                         step["ranking"].item()])
        out["energy_state"] = _state(agent)
    # (c) the pipeline under the group, the prior pinned (against JAX) or
    # drawn from a generator (against one process); RK45 also with each
    # rank's own norm, the control that must disagree
    pts = spec["pts"]
    for sampler in ("ode", "ode_adaptive"):
        pipe = _pipeline(spec, group, sampler, True)
        out[f"serve_{sampler}_pinned"] = pipe.predict(pts)
        # the frozen programs under the group (RK45: its norms reduced between graphs)
        out[f"serve_{sampler}_frozen"] = pipe.freeze().predict(pts)
        out[f"serve_{sampler}_drawn"] = _pipeline(spec, group, sampler, False).predict(
            pts, generator=torch.Generator().manual_seed(5))
    if group is not None:
        keep = parallel.mean_over_rows_
        parallel.mean_over_rows_ = lambda means, rows: means
        try:
            out["serve_rk45_per_rank_norm"] = _pipeline(
                spec, group, "ode_adaptive", True).predict(pts)
        finally:
            parallel.mean_over_rows_ = keep
    return out


def rank1_raises(group):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if group.rank == 1:
        raise ValueError("rank 1 fails")
    parallel.barrier(group)
    return group.rank
