"""Inference pipeline (counterpart of ``genpose_tpu/runners/serving.py``).

The serving chain, run eagerly on one device: zero-center the cloud ->
shared PointNet++ geometry (FPS + ball query: the CUDA kernels on a card) ->
K-hypothesis PF-ODE sampling with the score agent -> energies with the
energy agent -> decoupled rot/trans ranking -> top-ratio quaternion pooling
(``evaluation_single.py:356-489`` semantics).  Requests smaller than the
batch size are padded with copies of their last row, larger ones are
chunked.

Usage:
    pipe = InferencePipeline(cfg, score_ckpt=..., energy_ckpt=...)  # device="cuda"
    # or, with weights from the JAX package in memory:
    #   pipe.score_agent.load_jax(score_ema_shadow, score_batch_stats)
    #   pipe.energy_agent.load_jax(energy_params, energy_batch_stats)
    pipe.freeze().warmup()       # optional: CUDA graphs of the request's shape
    out = pipe.predict(pts)      # pts: [n, num_points, 3] float32 (meters)
    out["pred_pose"]             # [n, 7]  wxyz quaternion + translation
    out["sorted_hypotheses"]     # [n, K, pose_dim], best-energy first
    out["energy"]                # [n, K, 2]

The JAX pipeline samples with the score agent's EMA shadow and ranks with
the energy agent's live params; load the same sets here.  The checkpoints
are the port's own (``training/checkpoints.py``), as
``genpose_tpu_torch/tools/port_torch_ckpt.py`` writes them from a released
``.pth`` and ``tools/orbax_to_port.py`` from a JAX checkpoint; they load
model-only (weights, BatchNorm statistics, EMA shadow), as the JAX
pipeline loads its own (``genpose_tpu/runners/serving.py:36-62``).  The
sampler is ``cfg.sampler_mode[0]`` (``ode``, ``ode_adaptive``, ``pc``, or
``edm`` under ``sde_mode="edm"``), run for ``cfg.sampling_steps`` steps
from ``cfg.T0``.  ``freeze()`` is
the JAX pipeline's weights-as-constants program: both agents' sampling and
energy passes then replay CUDA graphs of a private copy of their weights
(``training/frozen.py``), with the geometry, the prior draw, the sort and
the pooling outside the graphs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import load_checkpoint
from genpose_tpu_torch.training.ranking import sort_poses_by_energy
from genpose_tpu_torch.utils.device import resolve_device


class InferencePipeline:
    """Load-once pose estimation service on one device."""

    def __init__(self, cfg: Config, batch_size: Optional[int] = None, device="cuda",
                 score_ckpt: Optional[str] = None, energy_ckpt: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bs = batch_size or cfg.batch_size
        self.K = cfg.eval_repeat_num
        self.keep = max(1, int(cfg.ratio * self.K))
        self.sampler = cfg.sampler_mode[0] if cfg.sampler_mode else "ode"
        self.score_agent = PoseAgent(cfg, "score", device=self.device)
        self.energy_agent = PoseAgent(cfg, "energy", device=self.device)
        if score_ckpt:
            load_checkpoint(score_ckpt, self.score_agent, load_model_only=True)
        if energy_ckpt:
            load_checkpoint(energy_ckpt, self.energy_agent, load_model_only=True)

    @torch.no_grad()
    def _run(self, pts: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        center = torch.mean(pts[:, :, :3], dim=1)
        batch = {
            "zero_mean_pts": torch.cat([pts[:, :, :3] - center[:, None, :], pts[:, :, 3:]],
                                       dim=-1),
            "pts_center": center,
        }
        # the geometry depends only on the coordinates: computed once, shared
        # by the score and energy encoders
        geom = self.score_agent.pts_geometry(batch["zero_mean_pts"])
        pred = self.score_agent.sample(
            batch, generator=generator, repeat_num=self.K, sampler=self.sampler,
            num_steps=self.cfg.sampling_steps, T0=self.cfg.T0, geometry=geom)
        energy = self.energy_agent.get_energy(batch, pred, T=1e-5, geometry=geom)
        sorted_pose, sorted_energy = sort_poses_by_energy(pred, energy)
        pred_q, avg = self.score_agent.aggregate_hypotheses(sorted_pose[:, :self.keep])
        return {
            "pred_pose": avg,                  # [n, 7] wxyz + t (pooled)
            "best_pose": pred_q[:, 0],         # [n, 7] best-energy
            "sorted_hypotheses": sorted_pose,  # [n, K, pose_dim]
            "energy": sorted_energy,           # [n, K, 2]
        }

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def freeze(self) -> "InferencePipeline":
        """Pin both agents' current weights (JAX ``serving.py:98-125``):
        ``predict`` then runs each agent's frozen programs for as long as it
        still holds the weights captured here (an agent whose weights change
        runs eagerly, as JAX runs its argument-passing program).  Call again
        after loading other weights."""
        self.score_agent.freeze()
        self.energy_agent.freeze()
        return self

    def warmup(self) -> "InferencePipeline":
        """Run one batch of zeros, so that the first request finds the kernels
        built, the libraries initialised and, after ``freeze()`` on a card,
        the CUDA graphs of the request's shape captured."""
        pts = torch.zeros((self.bs, self.cfg.num_points, 3), device=self.device)
        self._run(pts, self._generator(0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def predict(self, pts, generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
        """pts [n, num_points, 3] camera-frame meters -> dict of numpy arrays.

        n may be anything: short batches are padded, long ones chunked.  The
        prior noise comes from ``generator`` (on the pipeline's device;
        default: a fresh one seeded 0), so a call is deterministic per
        (pts, generator state).
        """
        pts = np.asarray(pts, np.float32)
        n = pts.shape[0]
        if n == 0:
            d = self.score_agent.pose_dim
            return {
                "pred_pose": np.zeros((0, 7), np.float32),
                "best_pose": np.zeros((0, 7), np.float32),
                "sorted_hypotheses": np.zeros((0, self.K, d), np.float32),
                "energy": np.zeros((0, self.K, 2), np.float32),
            }
        generator = generator if generator is not None else self._generator(0)
        outs = []
        for lo in range(0, n, self.bs):
            chunk = pts[lo:lo + self.bs]
            real = chunk.shape[0]
            if real < self.bs:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], self.bs - real, axis=0)], axis=0)
            out = self._run(torch.from_numpy(chunk).to(self.device), generator)
            outs.append({k: v[:real].cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
