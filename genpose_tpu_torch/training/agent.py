"""PoseAgent: training and inference orchestrator (counterpart of ``genpose_tpu/training/agent.py``).

One agent holds one ``GFObjectPose`` (score or energy) with its live
parameters in ``model`` and a ``TrainState`` (``training/state.py``) with the
optimizer state and the EMA shadow.  It exposes:

- ``pts_geometry`` (``agent.py:188-204``): the weight-independent PointNet++
  geometry of a cloud, shared by the score and energy encoders (None for
  the plain PointNet encoder);
- ``image_features``: under ``pts_encoder="dinov2_pointnet2"`` (GenPose++,
  no JAX counterpart) the frozen image tower over a batch's uint8 crops and
  the lifting of its patch features to the points.  Every method that
  encodes a batch's cloud reads them from the batch's ``features`` when it
  has them, else computes them from its ``rgb`` and ``pix`` (as
  ``data/process.py::process_batch`` leaves them) under ``no_grad``.
  ``train_step`` and ``train_step_distill`` leave them in the batch, so the
  EMA loss of the same batch and the teacher reuse them, and a serving
  request puts them there once for both nets: the tower runs once a batch.  Its weights are buffers, outside the
  optimizer, the EMA shadow and every gradient;
- ``train_step`` (``agent.py:292-308``): one encoder pass in train mode
  (BatchNorm on batch statistics, running statistics updated) and
  ``repeat_num`` DSM draws through one head call, then the optimizer step
  and the EMA update;
- ``ema_loss`` (``agent.py:310-317``), ``train_step_distill`` (``:323-359``)
  and ``zero_head_outputs`` (``:361-385``);
- ``train_step_energy`` (``:394-449``): DSM through the energy's autograd
  score plus the ranking loss over candidates sorted by their ground-truth
  errors;
- ``sample`` (``_sample_impl``, ``:455-575``: the ``ode``, ``ode_adaptive``,
  ``pc`` and ``edm`` samplers, with the trajectory on request), which reads
  the EMA shadow, ``get_energy`` (``:581-608``), which reads the live
  parameters, as the JAX callers do, and ``likelihood`` (``:614-626``),
  which reads the shadow;
- ``aggregate_hypotheses`` (``:632-642``);
- ``freeze`` (``:141-164``): ``sample`` and ``get_energy`` then run a
  private copy of the weights through static buffers (CUDA graphs on a
  card; ``training/frozen.py``) while the agent still holds the weights it
  captured.

Until the first optimizer step, or until a shadow is loaded, the EMA shadow
*is* the live parameters (``ema.shadow is None``), so weights loaded or
perturbed in ``model`` reach ``sample`` too.  A read of the shadow swaps it
into the parameters' storage for the call and swaps back after.

Precision follows ``cfg`` (``compute_dtype``, ``head_dtype``,
``geometry_dtype``, ``encoder_f32_stages``; ``models/posenet.py``): only
the matmuls and activations drop to bfloat16.  Parameters, BatchNorm
statistics, the EMA shadow, the optimizer moments and the samplers' state
stay float32, and so do the poses, energies and losses returned.

Under ``sde_mode="edm"`` (``is_edm``) a score agent has the EDM decoder
head and trains with the EDM loss; the runners' T0, a time fraction, maps
onto the sigma ladder (``diffusion/samplers.py::edm_sigma_start``).

Randomness comes from an explicit ``torch.Generator``; every draw can also
be passed in (``noise`` and ``t_int`` of the training steps, ``noise`` and
``latents`` of the PC and EDM samplers, ``t_int`` of ``get_energy``), so
that tests can give both packages the same numbers.  The frozen programs
serve every sampler (``ode``, ``ode_adaptive``, ``pc``, ``edm``), with or
without the trajectory and with injected draws, and the likelihood, as a
frozen JAX agent does; a frozen call equals the eager one bit for bit and
consumes the generator alike.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.diffusion.losses import dsm_loss_repeated, edm_dsm_loss_repeated
from genpose_tpu_torch.diffusion.samplers import (
    edm_sampler,
    edm_sigma_start,
    ode_likelihood,
    ode_sampler,
    ode_sampler_adaptive,
    pc_sampler,
)
from genpose_tpu_torch.diffusion.sde import init_sde
from genpose_tpu_torch.eval.metrics import pose_errors
from genpose_tpu_torch.models.layers import FusedTails, SplitTail
from genpose_tpu_torch.models.pointnet2 import cls_msg_geometry
from genpose_tpu_torch.models.posenet import build_model
from genpose_tpu_torch.models.vit import lift_features, normalize_crops
from genpose_tpu_torch.ops.pose import (
    average_quaternion_batch,
    get_pose_dim,
    get_rot_matrix,
    matrix_to_quat_wxyz,
)
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.training.frozen import FrozenPrograms
from genpose_tpu_torch.training.ranking import ranking_loss, sort_results
from genpose_tpu_torch.training.state import EMA, TrainState, create_train_state
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.weights import from_jax_variables, shadow_from_jax

Noise = Tuple[torch.Tensor, torch.Tensor]
SAMPLERS = ("ode", "ode_adaptive", "pc", "edm")


def _own_device(agent: "PoseAgent", *args, **kwargs) -> torch.device:
    """The device of a method's span: the agent's."""
    return agent.device


class PoseAgent:
    """Model + SDE + training state on one device."""

    def __init__(self, cfg: Config, posenet_mode: Optional[str] = None, device="cuda",
                 steps_per_epoch: int = 1000):
        self.cfg = cfg
        self.mode = posenet_mode or cfg.posenet_mode
        self.sde = init_sde(cfg.sde_mode)
        self.is_edm = cfg.sde_mode == "edm"
        self.pose_dim = get_pose_dim(cfg.pose_mode)
        self.model = build_model(cfg, self.mode, device=device)
        self.device = next(self.model.parameters()).device
        self.state: TrainState = create_train_state(
            base_lr=cfg.lr, warmup_steps=cfg.warmup, decay_per_epoch=cfg.lr_decay,
            steps_per_epoch=steps_per_epoch, floor_lr=cfg.lr_floor, grad_clip=cfg.grad_clip,
            ema_rate=cfg.ema_rate, optimizer=cfg.optimizer)
        self._frozen: Optional[FrozenPrograms] = None

    def params(self) -> Dict[str, torch.nn.Parameter]:
        """The live parameters by name (the Fourier ``W`` is a buffer, not among them)."""
        return dict(self.model.named_parameters())

    def load_jax(self, params: Mapping, batch_stats: Mapping,
                 ema_shadow: Optional[Mapping] = None) -> "PoseAgent":
        """Load JAX package weights (nested dicts of arrays; see
        ``utils/weights.py::from_jax_variables``) as the live parameters, and
        ``ema_shadow`` (same layout) as the EMA shadow; without it the shadow
        is the live parameters."""
        self.model.load_state_dict(from_jax_variables(params, batch_stats))
        shadow = None
        if ema_shadow is not None:
            shadow = shadow_from_jax(ema_shadow, params, self.params(), self.device)
        self.state.ema = EMA(self.state.ema.decay, shadow)
        return self

    def freeze(self) -> "PoseAgent":
        """Pin the current weights for inference (JAX ``agent.py:141-164``):
        ``sample`` and ``get_energy`` then run the frozen programs of
        ``training/frozen.py`` (a private copy of the weights; one set of CUDA
        graphs per shape on a card) for as long as the agent still holds the
        weights captured here.  Call again after loading other weights."""
        self._frozen = FrozenPrograms(self)
        return self

    def frozen_programs(self) -> Optional[FrozenPrograms]:
        """The programs of the last ``freeze()``, or None once the agent no
        longer holds the weights they captured (or was never frozen)."""
        frozen = self._frozen
        return frozen if frozen is not None and frozen.holds() else None

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def ema_weights(self):
        """Within the block the model computes with the EMA shadow (the live
        parameters while there is no separate shadow).  Not for use under
        autograd of the params."""
        shadow = self.state.ema.shadow
        if shadow is None:
            yield
            return
        params = self.params()
        live = {k: p.data for k, p in params.items()}
        try:
            for k, p in params.items():
                p.data = shadow[k]
            yield
        finally:
            for k, p in params.items():
                p.data = live[k]

    @trace.spanned("geometry")
    def pts_geometry(self, pts: torch.Tensor):
        """FPS + ball query + grouped coordinates of a cloud, for every SA
        stage, in the dtypes the encoder computes its inline geometry in
        (``agent.py:188-204``): ``geometry_dtype`` float32 makes every stage
        float32, else each stage takes its own dtype.  None for the plain
        PointNet encoder, which has no geometry pass; every method that
        takes a geometry takes None."""
        if self.cfg.pts_encoder == "pointnet":
            return None
        m = self.model
        if m.geometry_dtype is not None:
            return cls_msg_geometry(pts, self.cfg.pointnet2_params, dtype=m.geometry_dtype)
        return cls_msg_geometry(pts, self.cfg.pointnet2_params, dtype=m.dtype,
                                f32_stages=m.f32_stages)

    @torch.no_grad()
    def image_features(self, rgb: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
        """uint8 crops [bs, S, S, 3] and the points' crop pixels [bs, N, 2] ->
        the image tower's patch features lifted to the points [bs, N, 384]
        (``models/vit.py``)."""
        tower = self.model.image_tower
        with trace.span("image_tower", device=self.device, crops=rgb.shape[0]):
            grid = tower(normalize_crops(rgb))
        trace.count("image_tower.crops", rgb.shape[0])
        with trace.span("feature_lift"):
            feats = lift_features(grid, pix, tower.crop)
        trace.count("feature_lift.points", pix.shape[0] * pix.shape[1])
        return feats

    def _features(self, batch, keep: bool = False):
        """The lifted image features of ``batch`` (its ``features`` when it
        has them) for an encoder that takes them, else None.  ``keep``: leave
        them in the batch, so later calls on it reuse them."""
        if self.cfg.pts_encoder != "dinov2_pointnet2":
            return None
        if "features" not in batch:
            if "rgb" not in batch:
                raise ValueError("the dinov2_pointnet2 encoder needs the batch's RGB crops "
                                 "('rgb') and the points' crop pixels ('pix')")
            features = self.image_features(batch["rgb"], batch["pix"])
            if not keep:
                return features
            batch["features"] = features
        return batch["features"]

    def _encode(self, pts: torch.Tensor, train: bool, geometry=None,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The cloud feature; ``train`` runs BatchNorm on batch statistics and
        updates its running statistics (one train-mode pass per step)."""
        if not train:
            return self.model.encode_pts(pts, geometry=geometry, features=features)
        self.model.train()
        try:
            return self.model.encode_pts(pts, geometry=geometry, features=features)
        finally:
            self.model.eval()

    def _head_projs(self, feat: torch.Tensor, repeat: int = 1, tile: int = 1):
        """Tail projections of the cloud feature, folded AFTER the projection.

        ``repeat`` folds K hypotheses: ``repeat_interleave`` matches
        ``jnp.repeat(..., axis=0)``, so row b's copies are adjacent, as
        ``.reshape(bs, K, -1)`` expects.  ``tile`` stacks the batch once per
        DSM draw (row ``r * bs + b``), as ``dsm_loss_repeated`` lays out its
        draws."""
        projs = self.model.precompute_head(feat)

        def fold(p):
            if repeat > 1:
                p = p.repeat_interleave(repeat, dim=0)
            return p.repeat(tile, 1) if tile > 1 else p

        return tuple(fold(p) for p in projs) if isinstance(projs, tuple) else fold(projs)

    def _head_score_fn(self, feat: torch.Tensor, repeat: int = 1, tile: int = 1,
                       create_graph: bool = False):
        """score_fn(pose, t).  For an energy model the score is the gradient
        of the summed energy w.r.t. the pose (``agent.py:229-238``); under
        training (``create_graph``) that gradient stays differentiable in the
        parameters, so the DSM loss reaches the energy head (a double
        backward)."""
        projs = self._head_projs(feat, repeat, tile)
        model = self.model
        if self.mode == "score":
            def score_fn(pose, t):
                return model.score_with(projs, pose, t)
        else:
            def score_fn(pose, t):
                with torch.enable_grad():
                    # a pose already in a graph (the likelihood's divergence)
                    # stays in it
                    p = pose if pose.requires_grad else pose.detach().requires_grad_(True)
                    e = model.energy_with(projs, p, t, decoupled_rt=False)
                    (grad,) = torch.autograd.grad(e.sum(), p, create_graph=create_graph)
                return grad
        return score_fn

    def _head_denoise_fn(self, feat: torch.Tensor, repeat: int = 1, tile: int = 1,
                         create_graph: bool = False):
        """denoise_fn(pose, sigma) (``agent.py:253-274``): the decoder head's
        own, else D = x + sigma^2 s(x, sigma) from the score."""
        if self.model.decoder_head:
            projs = self._head_projs(feat, repeat, tile)
            model = self.model

            def denoise_fn(pose, t):
                return model.denoise_with(projs, pose, t)

            return denoise_fn
        score_fn = self._head_score_fn(feat, repeat, tile, create_graph)

        def denoise_fn(pose, t):
            _, sigma = self.sde.marginal_prob(None, t)
            return pose + torch.reshape(sigma, (-1, 1)) ** 2 * score_fn(pose, t)

        return denoise_fn

    def _head_energy_fn(self, feat: torch.Tensor, repeat: int = 1):
        projs = self._head_projs(feat, repeat)

        def energy_fn(pose, t):
            return self.model.energy_with(projs, pose, t, decoupled_rt=True)

        return energy_fn

    def _score_fn_and_center(self, pts, pts_center, geometry, repeat: int, features=None):
        """Encode the cloud (eval mode) and close score_fn over it for
        ``repeat`` hypotheses a cloud; the centers repeated alike."""
        feat = self._encode(pts, train=False, geometry=geometry, features=features)
        return (self._head_score_fn(feat, repeat=repeat),
                pts_center.repeat_interleave(repeat, dim=0))

    def _energies(self, pts, pts_center, pose_samples, t_input, geometry, features=None):
        """Energies [bs, K, 2] of camera-frame candidates [bs, K, pose_dim]
        at times t_input [bs * K, 1] (eval mode)."""
        bs, K, _ = pose_samples.shape
        feat = self._encode(pts, train=False, geometry=geometry, features=features)
        centered = torch.cat([pose_samples[..., :-3],
                              pose_samples[..., -3:] - pts_center[:, None, :]], dim=-1)
        energy_fn = self._head_energy_fn(feat, repeat=K)
        return energy_fn(centered.reshape(bs * K, -1), t_input).reshape(bs, K, -1)

    def _gf_loss(self, feat, gt_pose, generator=None, noise: Optional[Noise] = None,
                 teacher_score_fn=None, create_graph: bool = True) -> torch.Tensor:
        """The DSM term over ``cfg.repeat_num`` draws, or under EDM the EDM
        loss (``agent.py:276-286``); a teacher's distillation is DSM in
        either case (``agent.py:346-348``).  ``noise`` is (t, z), under EDM
        (sigma, z)."""
        if self.is_edm and teacher_score_fn is None:
            denoise_fn = self._head_denoise_fn(feat, tile=self.cfg.repeat_num,
                                               create_graph=create_graph)
            return edm_dsm_loss_repeated(denoise_fn, gt_pose, self.cfg.repeat_num,
                                         sigma_min=self.sde.eps, sigma_max=self.sde.T,
                                         generator=generator, noise=noise)
        score_fn = self._head_score_fn(feat, tile=self.cfg.repeat_num, create_graph=create_graph)
        return dsm_loss_repeated(score_fn, gt_pose, self.sde, self.cfg.repeat_num,
                                 teacher_score_fn=teacher_score_fn, generator=generator,
                                 noise=noise)

    def _optimize(self, loss_fn):
        """Run ``loss_fn() -> (loss, aux)`` with gradients on the live
        parameters, then one optimizer + EMA update.  Returns aux.  Inside
        ``parallel.sharded`` the gradients are averaged over the group first
        (one all-reduce), so clip, optimizer and EMA run alike on every rank.
        ``DistributedDataParallel`` would do nothing here: its reducer hooks
        the parameters' ``AccumulateGrad``, which ``torch.autograd.grad``
        never reaches."""
        params = self.params()
        for p in params.values():
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, aux = loss_fn()
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        finally:
            for p in params.values():
                p.requires_grad_(False)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        grads = parallel.average_gradients_(grads, parallel.active())
        self.state.apply_gradients(params, grads)
        return aux

    # ------------------------------------------------------------------
    # score training
    # ------------------------------------------------------------------

    @trace.spanned("train.step", device=_own_device)
    def train_step(self, batch, generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None) -> Dict[str, torch.Tensor]:
        """One optimization step of denoising score matching.  ``noise``:
        (t [repeat, bs, 1], z [repeat, bs, pose_dim]), else drawn from ``generator``.
        Leaves the batch's lifted image features in it as ``features``."""
        features = self._features(batch, keep=True)

        def loss_fn():
            feat = self._encode(batch["zero_mean_pts"], train=True, features=features)
            loss = self._gf_loss(feat, batch["zero_mean_gt_pose"], generator, noise)
            return loss, loss.detach()

        return {"gf": self._optimize(loss_fn)}

    @trace.spanned("train.ema_loss")
    @torch.no_grad()
    def ema_loss(self, batch, generator: Optional[torch.Generator] = None,
                 noise: Optional[Noise] = None) -> torch.Tensor:
        """The DSM loss under the EMA weights, for monitoring (``posenet_agent.py:200-224``)."""
        features = self._features(batch)
        with self.ema_weights():
            feat = self._encode(batch["zero_mean_pts"], train=False, features=features)
            return self._gf_loss(feat, batch["zero_mean_gt_pose"], generator, noise,
                                 create_graph=False)

    def train_step_distill(self, teacher: "PoseAgent", batch,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[Noise] = None) -> Dict[str, torch.Tensor]:
        """DSM against a frozen teacher's score (its EMA shadow, eval mode)
        instead of -z/std (``losses.py:79-82``, ``trainer.py:406-419``)."""
        if teacher is self:
            raise ValueError("the teacher must be another agent")
        pts = batch["zero_mean_pts"]
        features = self._features(batch, keep=True)     # the teacher's too: one frozen tower
        with teacher.ema_weights():
            with torch.no_grad():
                t_feat = teacher._encode(pts, train=False, features=teacher._features(batch))
            t_score = teacher._head_score_fn(t_feat, tile=self.cfg.repeat_num)

            def teacher_fn(pose, t):
                with torch.no_grad():
                    return t_score(pose, t).detach()

            def loss_fn():
                feat = self._encode(pts, train=True, features=features)
                loss = self._gf_loss(feat, batch["zero_mean_gt_pose"], generator, noise,
                                     teacher_score_fn=teacher_fn)
                return loss, loss.detach()

            return {"gf": self._optimize(loss_fn)}

    @torch.no_grad()
    def zero_head_outputs(self) -> None:
        """Re-zero the tail output layers after loading score weights into an
        energy net (``output_zero_initial``, ``trainer.py:426``); the EMA
        shadow becomes the live parameters again."""
        for m in self.model.modules():
            if isinstance(m, FusedTails):
                m.out_kernel.zero_()
                m.out_bias.zero_()
            elif isinstance(m, SplitTail):
                m.out.weight.zero_()
                m.out.bias.zero_()
        self.state.ema.shadow = None

    # ------------------------------------------------------------------
    # energy training (score DSM + ranking; ref posenet_agent.py:262-283)
    # ------------------------------------------------------------------

    def train_step_energy(self, batch, pose_samples: torch.Tensor,
                          generator: Optional[torch.Generator] = None, geometry=None,
                          noise: Optional[Noise] = None,
                          t_int: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """pose_samples [bs, K, pose_dim]: candidates from the (frozen) score
        model, translations in the camera frame.  ``geometry``: the encoder
        geometry of ``batch["zero_mean_pts"]``, shared with the candidates'
        sampling.  ``t_int`` [bs, 1]: integers in [1, 10) (t = t_int / 1e5),
        else drawn from ``generator``."""
        bs, K, _ = pose_samples.shape
        with torch.no_grad():
            flat = pose_samples.reshape(bs * K, -1)
            rot_err, trans_err = pose_errors(
                flat, batch["gt_pose"].repeat_interleave(K, dim=0),
                batch["id"].reshape(-1).repeat_interleave(K, dim=0),
                batch["handle_visibility"].reshape(-1).repeat_interleave(K, dim=0),
                self.cfg.synset_names, self.cfg.pose_mode, self.cfg.o2c_pose)
            metrics = torch.stack([rot_err, trans_err], dim=-1).reshape(bs, K, 2)
            centered = torch.cat([pose_samples[..., :-3],
                                  pose_samples[..., -3:] - batch["pts_center"][:, None, :]],
                                 dim=-1).reshape(bs * K, -1)
            if t_int is None:
                t_int = parallel.local_draw(
                    lambda n: torch.randint(1, 10, (n, 1), generator=generator,
                                            device=pose_samples.device), bs)
            t_samples = (t_int.to(pose_samples.dtype) / 1e5).repeat_interleave(K, dim=0)
        features = self._features(batch)

        def loss_fn():
            feat = self._encode(batch["zero_mean_pts"], train=True, geometry=geometry,
                                features=features)
            dsm = self._gf_loss(feat, batch["zero_mean_gt_pose"], generator, noise)
            energy = self._head_energy_fn(feat, repeat=K)(centered, t_samples)
            rank = ranking_loss(sort_results(energy.reshape(bs, K, 2), metrics))
            return dsm + rank, (dsm.detach(), rank.detach())

        dsm, rank = self._optimize(loss_fn)
        return {"gf": dsm, "ranking": rank}

    # ------------------------------------------------------------------
    # sampling (K hypotheses; ref posenet_agent.py:416-468)
    # ------------------------------------------------------------------

    @trace.spanned("sample", device=_own_device)
    @torch.no_grad()
    def sample(self, batch, generator: Optional[torch.Generator] = None, repeat_num: int = 1,
               sampler: Optional[str] = None, num_steps: Optional[int] = None,
               T0: Optional[float] = None, init_x: Optional[torch.Tensor] = None,
               geometry=None, return_geometry: bool = False, return_process: bool = False,
               noise=None, latents: Optional[torch.Tensor] = None):
        """batch {"zero_mean_pts" [bs, N, 3], "pts_center" [bs, 3]} ->
        pred_pose [bs, repeat_num, pose_dim] in the camera frame; with
        ``return_process`` first the trajectory [bs, repeat_num, steps,
        pose_dim] (``ode``, ``pc``, ``edm``); with ``return_geometry`` last
        the encoder geometry of the cloud (computed here if not given), for
        an energy pass over the same cloud.  ``init_x`` [bs, pose_dim]
        (zero-mean frame): each row's K samples start from it plus the prior
        at ``T0`` (``agent.py:502-503``).  Under EDM, T0 is a time fraction
        mapped onto the sigma ladder for every sampler (``agent.py:480-493``),
        and ``edm`` defaults to 18 steps.  ``noise``: PC's per-step draws
        (see ``pc_sampler``); ``latents``: EDM's unit prior [bs * repeat_num,
        pose_dim].  After ``freeze()`` the frozen programs run every sampler,
        trajectory and injected draw alike (same result, same draws from
        ``generator``).  A sampler name that neither package has raises
        before any work."""
        sampler = sampler or (self.cfg.sampler_mode[0] if self.cfg.sampler_mode else "ode")
        if sampler not in SAMPLERS:
            raise NotImplementedError(f"sampler {sampler!r} (the samplers are {SAMPLERS})")
        if sampler == "edm" and num_steps is None:
            num_steps = 18  # ref cond_edm_sampler's default (samplers.py:232)
        num_steps = num_steps or self.cfg.sampling_steps
        if sampler == "edm" and not self.is_edm:
            raise ValueError("sampler 'edm' needs sde_mode='edm'")
        if sampler == "ode_adaptive" and return_process:
            raise ValueError("ode_adaptive has no fixed trajectory")
        if self.is_edm and T0 is not None and sampler != "edm":
            T0 = edm_sigma_start(T0, self.sde.eps, self.sde.T)
        pts = batch["zero_mean_pts"]
        bs = pts.shape[0]
        frozen = self.frozen_programs()
        if frozen is not None:
            res, geometry = frozen.sample(batch, generator, repeat_num, sampler, num_steps, T0,
                                          init_x, geometry, return_process, noise, latents)
        else:
            if return_geometry and geometry is None:
                geometry = self.pts_geometry(pts)
            res = self._sample_eager(batch, generator, repeat_num, sampler, num_steps, T0,
                                     init_x, geometry, return_process, noise, latents,
                                     self._features(batch))
        if return_process:
            process, res = res
            process = process.reshape(bs, repeat_num, process.shape[1], -1)
        res = res.reshape(bs, repeat_num, -1)
        out = (process, res) if return_process else (res,)
        if return_geometry:
            out = out + (geometry,)
        return out if len(out) > 1 else res

    def _sample_eager(self, batch, generator, repeat_num, sampler, num_steps, T0, init_x,
                      geometry, return_process, noise, latents, features):
        pts = batch["zero_mean_pts"]
        rows = pts.shape[0] * repeat_num
        with self.ema_weights():
            feat = self._encode(pts, train=False, geometry=geometry, features=features)
            center_rep = batch["pts_center"].repeat_interleave(repeat_num, dim=0)
            init_rep = None if init_x is None else init_x.repeat_interleave(repeat_num, dim=0)
            kw = dict(init_x=init_rep, pts_center=center_rep, generator=generator,
                      device=pts.device)
            if sampler == "edm":
                res = edm_sampler(self._head_denoise_fn(feat, repeat=repeat_num), rows,
                                  self.cfg.pose_mode, num_steps=num_steps,
                                  sigma_min=self.sde.eps, sigma_max=self.sde.T,
                                  return_process=return_process, T0=T0, latents=latents, **kw)
            else:
                score_fn = self._head_score_fn(feat, repeat=repeat_num)
                args = (score_fn, rows, self.sde, self.cfg.pose_mode)
                if sampler == "ode":
                    res = ode_sampler(*args, num_steps=num_steps, T0=T0,
                                      return_process=return_process, **kw)
                elif sampler == "ode_adaptive":
                    res = ode_sampler_adaptive(*args, T0=T0, **kw)
                else:
                    res = pc_sampler(*args, num_steps=num_steps, T0=T0,
                                     return_process=return_process, noise=noise, **kw)
        return res

    # ------------------------------------------------------------------
    # energies of candidate poses (ref posenet_agent.py:471-527)
    # ------------------------------------------------------------------

    @trace.spanned("energy", device=_own_device)
    @torch.no_grad()
    def get_energy(self, batch, pose_samples: torch.Tensor, T: Optional[float] = None,
                   geometry=None, generator: Optional[torch.Generator] = None,
                   t_int: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Energies [bs, K, 2] of candidates [bs, K, pose_dim] (camera frame)
        under the live parameters, with the cloud center subtracted from the
        translations, at time T, or without T at t = t_int / 1e5 per cloud
        (``agent.py:595-603``) with ``t_int`` [bs, 1] integers in [1, 10)
        drawn from ``generator`` unless given; through the frozen programs
        after ``freeze()``."""
        bs, K, _ = pose_samples.shape
        dev = pose_samples.device
        if T is not None:
            t_input = torch.full((bs * K, 1), T, dtype=pose_samples.dtype, device=dev)
        else:
            if t_int is None:
                t_int = parallel.local_draw(
                    lambda n: torch.randint(1, 10, (n, 1), generator=generator, device=dev), bs)
            t_input = (t_int.to(pose_samples.dtype) / 1e5).repeat_interleave(K, dim=0)
        frozen = self.frozen_programs()
        if frozen is not None:
            return frozen.get_energy(batch, pose_samples, t_input, geometry)
        return self._energies(batch["zero_mean_pts"], batch["pts_center"], pose_samples,
                              t_input, geometry, self._features(batch))

    # ------------------------------------------------------------------
    # likelihood (ref posenet.py:133-147)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def likelihood(self, batch, poses: torch.Tensor, num_steps: int = 500):
        """PF-ODE log-likelihoods of poses [bs, pose_dim] (zero-centred
        translations) under the EMA shadow, with the exact divergence
        (``agent.py:614-626``): returns (latent z [bs, pose_dim], bits
        [bs]).  A frozen agent runs it on its frozen copy of the shadow."""
        frozen = self.frozen_programs()
        if frozen is not None:
            return frozen.likelihood(batch, poses, num_steps)
        features = self._features(batch)
        with self.ema_weights():
            feat = self._encode(batch["zero_mean_pts"], train=False, features=features)
            score_fn = self._head_score_fn(feat, create_graph=True)
            return ode_likelihood(score_fn, poses, self.sde, self.cfg.pose_mode,
                                  num_steps=num_steps)

    # ------------------------------------------------------------------
    # hypothesis aggregation (ref posenet_agent.py:450-463)
    # ------------------------------------------------------------------

    def aggregate_hypotheses(self, pred_pose: torch.Tensor):
        """Quaternion-average K hypotheses: (per-hypothesis [bs, K, 7],
        pooled [bs, 7]), both wxyz + t."""
        bs, K, _ = pred_pose.shape
        flat = pred_pose.reshape(bs * K, -1)
        rot = get_rot_matrix(flat[:, :-3], self.cfg.pose_mode)
        quat = matrix_to_quat_wxyz(rot).reshape(bs, K, 4)
        avg_q = average_quaternion_batch(quat)
        avg_t = torch.mean(pred_pose[..., -3:], dim=1)
        pred_q = torch.cat([quat, pred_pose[..., -3:]], dim=-1)
        return pred_q, torch.cat([avg_q, avg_t], dim=-1)
