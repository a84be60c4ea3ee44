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
- RK45: the encoder, the head's projections and the initial step as one
  graph, one attempt as a second, denoise and re-projection as a third.
  The host replays the attempt graph and reads ``done`` once per attempt,
  as the eager sampler does (``diffusion/samplers.py::integrate_adaptive``);
- energies: the encoder, the head's projections and the energy head.

Outside the graphs, eagerly: the PointNet++ geometry (the FPS and ball-query
wrappers count their launches per Python call), the prior, drawn from the
caller's generator so that a frozen call consumes it as an eager call does,
and whatever the caller does with the result (sorting, pooling, whose
eigen-solve checks its ``info`` on the host).  On the CPU the same
static-buffer code runs eagerly and nothing is captured.  On a card a
capture or replay that fails raises; nothing falls back to eager.

The programs serve only while the agent still holds the weights they
captured (JAX: ``self._frozen_state is self.state``): ``holds`` compares the
(address, version) of every parameter, buffer and shadow tensor with those
taken at freeze time, so loading weights, a training step,
``zero_head_outputs`` and ``utils/weights.py::perturb_`` each end them.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional

import torch

from genpose_tpu_torch.diffusion.samplers import ODEChain, RK45, integrate_adaptive, prior_rows
from genpose_tpu_torch.models.layers import cast_weights_

# The samplers with frozen programs; PC, EDM, trajectories and the
# likelihood run only eagerly, and a frozen agent asked for them raises.
FROZEN_SAMPLERS = ("ode", "ode_adaptive")

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
        self.warmup_s = self.capture_s = 0.0

    def capture(self, pool, stream) -> None:
        """Warm every segment up once on ``stream`` (libraries initialised,
        workspaces allocated), then capture each in the pool."""
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for seg in self.segments:
                seg.fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for seg in self.segments:
            seg.capture(pool, stream)
        torch.cuda.synchronize()
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def __call__(self):
        return self.drive(*self.segments)


class FrozenPrograms:
    """The frozen ``sample`` and ``get_energy`` of one agent, made by
    ``PoseAgent.freeze()``; ``programs`` holds one ``_Program`` per shape key:
    ``("sample", rows, K, N, sampler, num_steps, T, init_x given)`` and
    ``("energy", rows, K, N)``."""

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

    def _run(self, key: tuple, inputs, build: Callable) -> torch.Tensor:
        global dispatches
        prog = self.programs.get(key)
        if prog is None:
            static = _clone(inputs)
            prog = self.programs[key] = _Program(static, *build(*static))
            if self.pool is not None:
                prog.capture(self.pool, self.stream)
        else:
            _copy_into(prog.static, inputs)
        dispatches += 1
        return prog().clone()

    def sample(self, batch, generator: Optional[torch.Generator], repeat_num: int,
               sampler: str, num_steps: int, T0: Optional[float],
               init_x: Optional[torch.Tensor], geometry):
        """``PoseAgent.sample`` through the frozen programs: returns
        (pred_pose [bs, repeat_num, pose_dim], geometry).  Only the ``ode``
        (Heun) and ``ode_adaptive`` samplers have frozen programs; any other
        raises before anything runs."""
        if sampler not in FROZEN_SAMPLERS:
            raise NotImplementedError(
                f"the frozen path has no {sampler!r} sampler (it has {FROZEN_SAMPLERS})")
        agent, K = self.agent, repeat_num
        pts, center = batch["zero_mean_pts"], batch["pts_center"]
        bs = pts.shape[0]
        if geometry is None:
            geometry = agent.pts_geometry(pts)
        T = agent.sde.T if T0 is None else T0
        init_rep = None if init_x is None else init_x.repeat_interleave(K, dim=0)
        x0 = prior_rows(agent.sde, bs * K, agent.cfg.pose_mode, T, generator, pts.device,
                        init_rep)
        twin, sde, pose_mode = self.sample_twin, agent.sde, agent.cfg.pose_mode

        def build(pts, center, geometry, x0):
            if sampler == "ode":
                heun = ODEChain(sde, pose_mode, num_steps, T, pts.device)

                def chain():
                    score_fn, center_rep = twin._score_fn_and_center(pts, center, geometry, K)
                    return heun(score_fn, x0, center_rep)

                return [chain], lambda seg: seg()
            if sampler == "ode_adaptive":
                rk = RK45(sde, pose_mode, T, bs * K, pts.device)
                held = {}  # score_fn and the repeated centers, made by the first segment

                def start():
                    held["score_fn"], held["center"] = twin._score_fn_and_center(
                        pts, center, geometry, K)
                    rk.start(held["score_fn"], x0)

                fns = [start, lambda: rk.attempt(held["score_fn"]),
                       lambda: rk.finish(held["score_fn"], held["center"])]
                return fns, lambda *segs: integrate_adaptive(*segs, rk.done)[0]
            raise AssertionError(sampler)

        key = ("sample", bs, K, pts.shape[1], sampler, num_steps, T, init_x is not None)
        out = self._run(key, (pts, center, geometry, x0), build)
        return out.reshape(bs, K, -1), geometry

    def get_energy(self, batch, pose_samples: torch.Tensor, t_input: torch.Tensor,
                   geometry) -> torch.Tensor:
        """``PoseAgent.get_energy`` through the frozen programs."""
        pts = batch["zero_mean_pts"]
        if geometry is None:
            geometry = self.agent.pts_geometry(pts)
        twin = self.energy_twin

        def build(*static):
            return [lambda: twin._energies(*static)], lambda seg: seg()

        bs, K, _ = pose_samples.shape
        return self._run(("energy", bs, K, pts.shape[1]),
                         (pts, batch["pts_center"], pose_samples, t_input, geometry), build)
