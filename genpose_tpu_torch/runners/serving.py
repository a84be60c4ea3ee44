"""Inference pipeline (counterpart of ``genpose_tpu/runners/serving.py``).

The serving chain, run eagerly on one device: zero-center the cloud ->
shared PointNet++ geometry (FPS + ball query: the CUDA kernels on a card) ->
K-hypothesis PF-ODE sampling with the score agent -> energies with the
energy agent -> decoupled rot/trans ranking -> top-ratio quaternion pooling
(``evaluation_single.py:356-489`` semantics).  Requests smaller than the
batch size are padded with copies of their last row, larger ones are
chunked.  Under ``dinov2_pointnet2`` the frozen image tower runs once a
chunk, beside the geometry: the score agent's tower over the crops, its
features lifted to the points and given to both encoders.

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
    # under pts_encoder="dinov2_pointnet2" (GenPose++) a request also carries
    # each object's RGB crop and each point's crop pixel:
    #   pipe.predict(pts, rgb=crops, pix=pixels)  # uint8 [n, 224, 224, 3], [n, N, 2]

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
(``training/frozen.py``) under every sampler, with the geometry, the
sampler's draws from the request's generator, the sort and the pooling
outside the graphs.

Under a data-parallel group (``group=parallel.make_group(...)``, one
pipeline per rank, every rank calling ``predict`` with the same clouds and
generator state) each padded chunk is split over the ranks, each rank runs
its rows inside ``parallel.sharded`` (the prior's draws of the whole chunk,
RK45's norm over every rank's rows) and the outputs are gathered, so every
rank returns the whole result (JAX ``serving.py:173-176``).  The batch size
must divide over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.models.vit import CROP
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import load_checkpoint
from genpose_tpu_torch.training.ranking import sort_poses_by_energy
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.device import resolve_device


class InferencePipeline:
    """Load-once pose estimation service on one device, or on each rank of
    a data-parallel ``group`` (on the group's device)."""

    def __init__(self, cfg: Config, batch_size: Optional[int] = None, device="cuda",
                 score_ckpt: Optional[str] = None, energy_ckpt: Optional[str] = None,
                 group: Optional[parallel.DPGroup] = None):
        self.cfg = cfg
        self.group = group
        self.device = group.device if group is not None else resolve_device(device)
        self.bs = batch_size or cfg.batch_size
        if group is not None and self.bs % group.world:
            raise ValueError(f"batch size {self.bs} does not divide over {group.world} ranks")
        self.K = cfg.eval_repeat_num
        self.keep = max(1, int(cfg.ratio * self.K))
        self.sampler = cfg.sampler_mode[0] if cfg.sampler_mode else "ode"
        self.takes_crops = cfg.pts_encoder == "dinov2_pointnet2"
        self.score_agent = PoseAgent(cfg, "score", device=self.device)
        self.energy_agent = PoseAgent(cfg, "energy", device=self.device)
        if score_ckpt:
            load_checkpoint(score_ckpt, self.score_agent, load_model_only=True)
        if energy_ckpt:
            load_checkpoint(energy_ckpt, self.energy_agent, load_model_only=True)

    @torch.no_grad()
    def _run(self, pts: torch.Tensor, generator: torch.Generator,
             crops: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        center = torch.mean(pts[:, :, :3], dim=1)
        batch = {
            "zero_mean_pts": torch.cat([pts[:, :, :3] - center[:, None, :], pts[:, :, 3:]],
                                       dim=-1),
            "pts_center": center,
        }
        # the geometry depends only on the coordinates: computed once, shared
        # by the score and energy encoders
        geom = self.score_agent.pts_geometry(batch["zero_mean_pts"])
        # so do the image tower's lifted features (the tower is the same in both nets)
        if crops is not None:
            batch["features"] = self.score_agent.image_features(crops["rgb"], crops["pix"])
        pred = self.score_agent.sample(
            batch, generator=generator, repeat_num=self.K, sampler=self.sampler,
            num_steps=self.cfg.sampling_steps, T0=self.cfg.T0, geometry=geom)
        energy = self.energy_agent.get_energy(batch, pred, T=1e-5, geometry=geom)
        with trace.span("rank_pool"):
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
        world = self.group.world if self.group is not None else 1
        rows = self.bs // world
        pts = torch.zeros((rows, self.cfg.num_points, 3), device=self.device)
        crops = None
        if self.takes_crops:
            crops = {"rgb": torch.zeros((rows, CROP, CROP, 3), dtype=torch.uint8,
                                        device=self.device),
                     "pix": torch.full((rows, self.cfg.num_points, 2), CROP / 2,
                                       device=self.device)}
        with parallel.sharded(self.group):
            self._run(pts, self._generator(0), crops)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def predict(self, pts, generator: Optional[torch.Generator] = None, rgb=None,
                pix=None) -> Dict[str, np.ndarray]:
        """pts [n, num_points, 3] camera-frame meters -> dict of numpy arrays.

        n may be anything: short batches are padded, long ones chunked.  The
        prior noise comes from ``generator`` (on the pipeline's device;
        default: a fresh one seeded 0), so a call is deterministic per
        (pts, generator state).  ``rgb`` (uint8 [n, 224, 224, 3], each
        object's crop) and ``pix`` ([n, num_points, 2], each point's crop
        pixel): what ``dinov2_pointnet2`` needs and no other encoder takes.
        """
        pts = np.asarray(pts, np.float32)
        if (rgb is not None) != self.takes_crops or (rgb is None) != (pix is None):
            raise ValueError(f"pts_encoder={self.cfg.pts_encoder!r} takes "
                             f"{'rgb and pix' if self.takes_crops else 'no rgb or pix'}")
        arrays = {"pts": pts}
        if self.takes_crops:
            arrays.update(rgb=np.asarray(rgb, np.uint8), pix=np.asarray(pix, np.float32))
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
        with trace.span("serve.request", device=self.device, rows=n):
            for lo in range(0, n, self.bs):
                chunk = {k: v[lo:lo + self.bs] for k, v in arrays.items()}
                real = chunk["pts"].shape[0]
                if real < self.bs:
                    chunk = {k: np.concatenate([v, np.repeat(v[-1:], self.bs - real, axis=0)],
                                               axis=0) for k, v in chunk.items()}
                with trace.span("serve.copy_in"):
                    local = parallel.shard_batch(self.group, {
                        k: torch.from_numpy(v).to(self.device) for k, v in chunk.items()})
                pts_local = local.pop("pts")
                with parallel.sharded(self.group):
                    out = self._run(pts_local, generator, local or None)
                out = parallel.all_gather_rows(self.group, out)
                with trace.span("serve.copy_out"):
                    outs.append({k: v[:real].cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
