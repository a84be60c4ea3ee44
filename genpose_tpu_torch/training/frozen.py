"""Frozen inference programs of a ``PoseAgent`` (``PoseAgent.freeze()``;
counterpart of ``genpose_tpu/training/agent.py:141-164``).

The JAX package bakes the agent's state into its sampling and energy
programs as constants and runs each as one compiled XLA program.  Here
``freeze()`` takes a private copy of the weights those programs read (the
EMA shadow, or the live parameters when there is none, for ``sample``; the
live parameters for ``get_energy``; each with the BatchNorm statistics and
the Fourier ``W``) and runs the encoder, the head and the sampler over
static buffers.  Under a bfloat16 compute dtype the copy holds its matmul
weights in bfloat16, cast once here as JAX bakes them into its program, so
no weight is cast inside the chain; the values are those the eager casts
give, so frozen equals eager bit for bit in bfloat16 as in float32.  On a card each shape key is captured once into CUDA graphs
(after a warm-up on the capture stream, all graphs of an agent in one
memory pool) and replayed after:

- Heun: the encoder, the head's projections, the whole chain of steps and
  the denoise step as ONE graph, the counterpart of JAX's one program
  (about 40 kernels a score evaluation, so ~40,000 nodes at 500 steps).
  Replaying a run of steps instead would need the step's time in a device
  buffer and a host loop; one graph keeps the host out of the chain;
- PC and EDM: likewise the encoder, the head's projections and the whole
  chain as ONE graph (``diffusion/samplers.py::PCChain``, ``EDMChain``);
  PC-500 is ~1,000 score evaluations, as Heun-500;
- a trajectory (``return_process``, Heun, PC or EDM): the same one graph,
  which also writes the [rows, steps, pose_dim] trajectory;
- RK45: the encoder, the head's projections and the initial step as one
  graph, one attempt as a second, denoise and re-projection as a third.
  The host replays the attempt graph and reads ``done`` once per attempt,
  as the eager sampler does (``diffusion/samplers.py::integrate_adaptive``).
  Under a group of several ranks the initial step is three graphs and an
  attempt two, split at their norms (``RK45.start_phases``,
  ``attempt_phases``), and between them the host makes the norms' means
  global (``RK45.reduce``), so no collective is captured;
- energies: the encoder, the head's projections and the energy head.

Outside the graphs, eagerly: the PointNet++ geometry (the FPS and ball-query
wrappers count their launches per Python call in their ``launches``, which
``utils/trace.py::snapshot`` reads with ``dispatches`` and
``frozen.captures``); under ``dinov2_pointnet2`` the frozen copy's image
tower and the lifting of its features (or the batch's ``features``, which
a serving request puts there once for both nets), which enter the programs
as a static input as the geometry does; every draw of the sampler,
made from the caller's generator by the helpers the eager samplers call
(``prior_rows``, ``pc_start``, ``pc_draws``, ``edm_draws``), so that a frozen
call consumes the generator as an eager call does, and copied into the
program's static buffers with any draws the caller passed in (PC's
``noise``, EDM's ``latents``); the likelihood, whose divergence is a
backward pass per pose dimension, run on the frozen copy of the weights as
JAX runs it unfrozen on its pinned state; and whatever the caller does with
the result (sorting, pooling, whose eigen-solve checks its ``info`` on the
host).  Under a group of several ranks PC's chain is not captured: its
corrector averages the score norm over every rank's rows at each step.  On
the CPU the same static-buffer code runs eagerly and nothing is
captured.  On a card a capture or replay that fails raises; nothing falls
back to eager.

The programs serve only while the agent still holds the weights they
captured (JAX: ``self._frozen_state is self.state``): ``holds`` compares the
(address, version) of every parameter, buffer and shadow tensor with those
taken at freeze time, so loading weights, a training step,
``zero_head_outputs`` and ``utils/weights.py::perturb_`` each end them.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import torch

from genpose_tpu_torch.diffusion.samplers import (
    RK45,
    EDMChain,
    ODEChain,
    PCChain,
    edm_draws,
    integrate_adaptive,
    ode_likelihood,
    pc_draws,
    pc_start,
    prior_rows,
)
from genpose_tpu_torch.models.layers import cast_weights_
from genpose_tpu_torch.ops.pose import get_pose_dim
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.utils import trace

# Calls served by frozen programs since import.  A run that resets it and
# reads it afterwards shows whether a path went through them.
dispatches = 0


def _clone(tree):
    """A copy of a nest of tuples, lists and dicts whose tensors are cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _watched(agent) -> List[torch.Tensor]:
    shadow = agent.state.ema.shadow or {}
    return [*agent.model.parameters(), *agent.model.buffers(),
            *(shadow[k] for k in sorted(shadow))]


def _fingerprint(agent):
    return (agent.state.ema.shadow is None,
            [(t.data_ptr(), t._version) for t in _watched(agent)])


def _twin(agent, shadow):
    """An agent that computes with a private copy of ``agent``'s model,
    holding ``shadow`` as its parameters when given, each matmul weight
    stored in its module's compute dtype (``models/layers.py::cast_weights_``)."""
    model = copy.deepcopy(agent.model)
    if shadow is not None:
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(shadow[k])
    cast_weights_(model)
    twin = copy.copy(agent)
    twin.model, twin._frozen = model, None
    return twin


class _Segment:
    """A callable without arguments over static buffers: called as it is on
    the CPU; on a card captured once into a CUDA graph and replayed."""

    def __init__(self, fn: Callable):
        self.fn, self.graph, self.out = fn, None, None

    def capture(self, pool, stream) -> None:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = self.fn()

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        return self.out


class _Program:
    """One shape key: its static inputs, its segments and ``drive``, which
    runs the segments in the sampler's order and returns the result."""

    def __init__(self, static, fns: List[Callable], drive: Callable):
        self.static, self.drive = static, drive
        self.segments = [_Segment(fn) for fn in fns]
        self.fused_evals = self.fused_sa = 0

    def capture(self, pool, stream) -> None:
        """Warm every segment up once on ``stream`` (libraries initialised,
        workspaces allocated; the span ``frozen.warmup``), then capture each
        in the pool.  ``fused_evals``: the score evaluations the captured
        graphs run through the fused head kernel, i.e. one replay's;
        ``fused_sa``: the grouped SA radii they run through the SA stage
        kernel."""
        with trace.span("frozen.warmup"):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for seg in self.segments:
                    seg.fn()
            torch.cuda.synchronize()
        before = trace.snapshot()
        for seg in self.segments:
            seg.capture(pool, stream)
        torch.cuda.synchronize()
        after = trace.snapshot()
        self.fused_evals = after["score_head.fused"] - before["score_head.fused"]
        self.fused_sa = after["sa_stage.fused"] - before["sa_stage.fused"]

    def __call__(self):
        return self.drive(*self.segments)


class FrozenPrograms:
    """The frozen ``sample`` and ``get_energy`` of one agent, made by
    ``PoseAgent.freeze()``; ``programs`` holds one ``_Program`` per shape key:
    ``("sample", rows, K, N, sampler, num_steps, T, init_x given,
    return_process, noise given, latents given)`` and ``("energy", rows, K,
    N)``."""

    def __init__(self, agent):
        self.agent = agent
        shadow = agent.state.ema.shadow
        self.energy_twin = _twin(agent, None)
        self.sample_twin = self.energy_twin if shadow is None else _twin(agent, shadow)
        # keeps the watched storages alive, so that no address is reused
        self._pinned = [t.detach() for t in _watched(agent)]
        self._print = _fingerprint(agent)
        self.programs: Dict[tuple, _Program] = {}
        cuda = agent.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(device=agent.device) if cuda else None

    def holds(self) -> bool:
        """Whether the agent still holds the weights captured at freeze time."""
        return _fingerprint(self.agent) == self._print

    def _run(self, key: tuple, inputs, build: Callable, capture: bool = True) -> torch.Tensor:
        global dispatches
        prog = self.programs.get(key)
        if prog is None:
            static = _clone(inputs)
            prog = self.programs[key] = _Program(static, *build(*static))
            if self.pool is not None and capture:
                trace.count("frozen.captures")
                # host time only: no event may be recorded inside a capture
                with trace.span("frozen.capture", mode=self.agent.mode, kind=key[0],
                                rows=key[1], K=key[2], graphs=len(prog.segments)) as sp:
                    prog.capture(self.pool, self.stream)
                    if sp is not None:
                        sp.attrs["fused_evals"] = prog.fused_evals
                        sp.attrs["fused_sa"] = prog.fused_sa
        else:
            _copy_into(prog.static, inputs)
        dispatches += 1
        with trace.span("frozen.replay", kind=key[0]):
            return _clone(prog())

    def sample(self, batch, generator: Optional[torch.Generator], repeat_num: int,
               sampler: str, num_steps: int, T0: Optional[float],
               init_x: Optional[torch.Tensor], geometry, return_process: bool = False,
               noise=None, latents: Optional[torch.Tensor] = None):
        """``PoseAgent.sample`` through the frozen programs (every sampler of
        the agent: ``ode``, ``ode_adaptive``, ``pc``, ``edm``): returns
        (pred_pose [bs, repeat_num, pose_dim], geometry), with
        ``return_process`` ((trajectory [bs * repeat_num, steps, pose_dim],
        pred_pose), geometry).  ``noise`` / ``latents`` as the agent's."""
        agent, K = self.agent, repeat_num
        pts, center = batch["zero_mean_pts"], batch["pts_center"]
        bs, dev = pts.shape[0], pts.device
        rows, pose_mode, sde = bs * K, agent.cfg.pose_mode, agent.sde
        shape = (rows, get_pose_dim(pose_mode))
        twin = self.sample_twin
        if geometry is None:
            geometry = agent.pts_geometry(pts)
        features = twin._features(batch)
        init_rep = None if init_x is None else init_x.repeat_interleave(K, dim=0)
        # the draws, in the order the eager sampler makes them
        T = sde.T if T0 is None else T0
        if sampler == "edm":
            chain = EDMChain(pose_mode, num_steps, dev, sigma_min=sde.eps, sigma_max=sde.T, T0=T0)
            draws = edm_draws(generator, shape, num_steps, chain.churn, dev, latents)
            starts = (init_rep, *draws)
        elif sampler == "pc":
            T, x0 = pc_start(sde, rows, pose_mode, T0, generator, dev, init_rep)
            if noise is None:
                noise = pc_draws(generator, num_steps, shape, dev)
            starts = (x0, tuple(noise))
        else:
            starts = (prior_rows(sde, rows, pose_mode, T, generator, dev, init_rep),)
        # under a group of several ranks the samplers' norms reduce over
        # every rank's rows, which no graph may hold
        group = parallel.active()
        grouped = group is not None and group.world > 1

        def build(pts, center, geometry, features, *starts):
            def encoded():
                if sampler == "edm":
                    feat = twin._encode(pts, train=False, geometry=geometry, features=features)
                    return (twin._head_denoise_fn(feat, repeat=K),
                            center.repeat_interleave(K, dim=0))
                return twin._score_fn_and_center(pts, center, geometry, K, features)

            if sampler == "ode_adaptive":
                rk = RK45(sde, pose_mode, T, rows, dev)
                held = {}  # score_fn and the repeated centers, made by the first segment

                def finish():
                    return rk.finish(held["score_fn"], held["center"])

                if not grouped:  # the reductions are the identity: a graph each
                    def start():
                        held["score_fn"], held["center"] = encoded()
                        rk.start(held["score_fn"], starts[0])

                    return ([start, lambda: rk.attempt(held["score_fn"]), finish],
                            lambda *segs: integrate_adaptive(*segs, rk.done)[0])

                def start_a():
                    held["score_fn"], held["center"] = encoded()
                    rk.start_a(held["score_fn"], starts[0])

                fns = [start_a, lambda: rk.start_b(held["score_fn"]), rk.start_c,
                       lambda: rk.attempt_a(held["score_fn"]), rk.attempt_b, finish]

                def drive(sa, sb, sc, aa, ab, fin):
                    # the norms' reductions run between the graphs, never in one
                    return integrate_adaptive(rk.chain([sa, sb, sc], rk.START_SLOTS),
                                              rk.chain([aa, ab], rk.ATTEMPT_SLOTS), fin,
                                              rk.done)[0]

                return fns, drive
            if sampler == "ode":
                heun = ODEChain(sde, pose_mode, num_steps, T, dev)

                def run(fn, center_rep):
                    return heun(fn, starts[0], center_rep, return_process)
            elif sampler == "pc":
                pc = PCChain(sde, pose_mode, num_steps, T, dev)

                def run(fn, center_rep):
                    return pc(fn, starts[0], starts[1], center_rep, return_process)
            else:
                def run(fn, center_rep):
                    init, lat, churn = starts
                    return chain(fn, lat, center_rep, init, churn, return_process)

            return [lambda: run(*encoded())], lambda seg: seg()

        # PC's corrector reduces over every rank's rows at each step, inside
        # its chain: under a group of several ranks the chain runs uncaptured
        capture = not (sampler == "pc" and grouped)
        key = ("sample", bs, K, pts.shape[1], sampler, num_steps, T, init_x is not None,
               return_process, noise is not None, latents is not None, grouped)
        out = self._run(key, (pts, center, geometry, features, *starts), build, capture)
        if return_process:
            return out, geometry
        return out.reshape(bs, K, -1), geometry

    def likelihood(self, batch, poses: torch.Tensor, num_steps: int):
        """``PoseAgent.likelihood`` on the frozen copy of the weights the
        sampling programs read, run eagerly (JAX ``agent.py:614-626`` runs
        it unfrozen on the pinned state): (latent z, bits)."""
        global dispatches
        twin = self.sample_twin
        dispatches += 1
        feat = twin._encode(batch["zero_mean_pts"], train=False, features=twin._features(batch))
        return ode_likelihood(twin._head_score_fn(feat, create_graph=True), poses, twin.sde,
                              twin.cfg.pose_mode, num_steps=num_steps)

    def get_energy(self, batch, pose_samples: torch.Tensor, t_input: torch.Tensor,
                   geometry) -> torch.Tensor:
        """``PoseAgent.get_energy`` through the frozen programs."""
        pts = batch["zero_mean_pts"]
        if geometry is None:
            geometry = self.agent.pts_geometry(pts)
        twin = self.energy_twin
        features = twin._features(batch)

        def build(*static):
            return [lambda: twin._energies(*static)], lambda seg: seg()

        bs, K, _ = pose_samples.shape
        return self._run(("energy", bs, K, pts.shape[1]),
                         (pts, batch["pts_center"], pose_samples, t_input, geometry, features),
                         build)
