"""Pose samplers (counterpart of ``genpose_tpu/diffusion/samplers.py``).

- ``ode_sampler``: fixed-step PF-ODE over ``linspace(T, eps, num_steps)``
  with Heun (the config default ``sampler_mode=("ode",)``), Euler or RK4
  steps, then a denoise step (JAX ``samplers.py:45-143``);
- ``ode_sampler_adaptive``: Dormand-Prince RK45 with scipy's step
  controller, one step size for the whole flattened batch, at most
  2000 attempts and a final denoise step (JAX ``samplers.py:145-271``; reference
  ``cond_ode_sampler``, which runs scipy ``solve_ivp`` at atol/rtol 1e-5);
- ``pc_sampler``: predictor-corrector, a Langevin corrector and an
  Euler-Maruyama predictor on the reverse SDE per step (JAX
  ``samplers.py:274-381``, with its two documented fixes of the reference);
- ``ode_likelihood``: the PF-ODE log-likelihood in bits, with the exact
  divergence or a Hutchinson probe (JAX ``samplers.py:384-460``);
- ``edm_sampler``: the EDM Heun sampler over a denoiser on the Karras
  rho-ladder (JAX ``samplers.py:462-564``).

The score samplers take ``score_fn(pose, t) -> score`` closed over the
encoded cloud, ``edm_sampler`` a ``denoise_fn(pose, sigma)``.  Every draw
comes from an explicit ``torch.Generator`` or is passed in: the prior
through ``sde.prior``, PC's per-step draws as ``noise``, EDM's unit prior as
``latents`` and its churn draws as ``noise``, the Hutchinson probe as
``epsilon``.  With ``init_x`` (tracking: the previous frame's pose, started
at a reduced ``T0``) the integration starts from ``init_x + prior`` (JAX
``samplers.py:69,189``; reference ``samplers.py:180``).  ``return_process``
also returns the trajectory [rows, steps, pose_dim], rotations re-projected
and the cloud centre added, as JAX lays it out.

The integrations live in ``ODEChain`` (fixed-step), ``RK45``, ``PCChain``
and ``EDMChain``, which the samplers run eagerly and ``training/frozen.py``
captures in CUDA graphs.  Each builds its constants (the time grid or the
sigma ladder, eps, the step bounds) as device tensors when it is made,
outside any capture, and then launches device work only.  PC and EDM take
their per-step draws from buffers, which ``pc_draws`` and ``edm_draws`` fill
from a generator: the eager samplers and the frozen programs both call
them, so both consume a generator alike by construction (the same calls in
the same order as the loop of steps once made them).  ``RK45`` keeps its
state ``t, x, f, h, rejected, done`` in tensors of its own that each attempt
updates in place; its accept/reject control lives on the device, as in the
JAX ``while_loop``, and the host reads one flag per attempt to decide
whether to stop (``integrate_adaptive``).  The likelihood runs eagerly
only: its divergence is a backward pass per pose dimension.

The state stays float32 under a bfloat16 compute dtype: the heads return
float32 scores (JAX promotes the same way), and ``_score`` refuses any
other, since a bfloat16 score times a 0-dim float32 coefficient would stay
bfloat16 in PyTorch and round the step silently.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from genpose_tpu_torch.diffusion.sde import SDE
from genpose_tpu_torch.ops.pose import get_pose_dim, normalize_rotation
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.utils.device import resolve_device


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace``'s float32 formula: start*(1-s) + stop*s with
    s = i/(num-1), and the last value exactly ``stop``."""
    f32 = torch.float32
    start_t = _scalar(start, device)
    stop_t = _scalar(stop, device)
    if num == 1:
        return start_t[None]
    div = num - 1
    step = torch.arange(div, dtype=f32, device=device) / torch.tensor(div, dtype=f32)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


def _finish(x: torch.Tensor, pose_mode: str, pts_center: torch.Tensor) -> torch.Tensor:
    """Re-project the rotation and move the translation back to the camera frame."""
    rot = normalize_rotation(x[:, :-3], pose_mode)
    return torch.cat([rot, x[:, -3:] + pts_center], dim=-1)


def _score(score_fn: Callable, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """score_fn(x, t) at the batch-shared time t as a [1, 1] row, in x's dtype."""
    s = score_fn(x, t.reshape(1, 1))
    if s.dtype != x.dtype:
        raise TypeError(f"the score is {s.dtype}, the integration state {x.dtype}")
    return s


def _ode_dx(score_fn: Callable, sde: SDE, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """PF-ODE right-hand side.  ``sde.sde`` returns the drift COEFFICIENT c(t)
    of f(x, t) = c(t) x; t is shared across the batch as a [1, 1] row."""
    drift, diffusion = sde.sde(t)
    return drift * x - 0.5 * (diffusion ** 2) * _score(score_fn, x, t)


def _denoise(score_fn, sde: SDE, x: torch.Tensor, step: float,
             eps: torch.Tensor) -> torch.Tensor:
    """Reverse-diffusion predictor at ``eps`` (``sde.eps`` as a device
    scalar; ref ``samplers.py:209-218``), with the correct sign (the
    reference's flip is ~1e-5 at sigma(eps)=0.01)."""
    drift, diffusion = sde.sde(eps)
    grad = _score(score_fn, x, eps)
    return x + (diffusion ** 2 * grad - drift * x) * step


def _sampler_device(device, pts_center: Optional[torch.Tensor],
                    generator: Optional[torch.Generator]) -> torch.device:
    """Where a sampler builds its state: ``device`` when given, else
    ``pts_center``'s device, else ``generator``'s, else the card (raising
    without one, as every entry point of the port does)."""
    if device is not None:
        return resolve_device(device)
    if pts_center is not None:
        return pts_center.device
    if generator is not None:
        return generator.device
    return resolve_device("cuda")


def prior_rows(sde: SDE, batch_size: int, pose_mode: str, T: float,
               generator: Optional[torch.Generator], device,
               init_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The start of the integration: a prior draw at T, added to ``init_x`` if
    given (inside ``parallel.sharded``, this rank's rows of the global draw)."""
    x = parallel.local_draw(
        lambda n: sde.prior((n, get_pose_dim(pose_mode)), T=T, generator=generator,
                            device=device), batch_size)
    return x if init_x is None else init_x + x


def _finish_process(xs, pose_mode: str, pts_center: torch.Tensor) -> torch.Tensor:
    """A trajectory, a list of [rows, d] states, as [rows, steps, d] with
    each rotation re-projected and the centre added (JAX ``_normalize_traj``)."""
    return torch.stack([_finish(x, pose_mode, pts_center) for x in xs], dim=1)


class ODEChain:
    """A fixed-step PF-ODE integration from T to eps in ``num_steps - 1``
    steps of ``integrator`` (``heun``, ``euler`` or ``rk4``), then the
    denoise step and the re-projection.  ``ts`` and eps are built here; a
    call launches device work only, so a CUDA graph can capture it whole."""

    def __init__(self, sde: SDE, pose_mode: str, num_steps: int, T: float, device,
                 integrator: str = "heun"):
        if integrator not in ("heun", "euler", "rk4"):
            raise NotImplementedError(integrator)
        self.sde, self.pose_mode, self.num_steps = sde, pose_mode, num_steps
        self.integrator = integrator
        self.ts = _linspace(T, sde.eps, num_steps, device)
        self.eps = _scalar(sde.eps, device)

    def _step(self, score_fn: Callable, x: torch.Tensor, t: torch.Tensor,
              t_next: torch.Tensor) -> torch.Tensor:
        sde, dt = self.sde, t_next - t
        k1 = _ode_dx(score_fn, sde, x, t)
        if self.integrator == "euler":
            return x + dt * k1
        if self.integrator == "heun":
            k2 = _ode_dx(score_fn, sde, x + dt * k1, t_next)
            return x + dt * 0.5 * (k1 + k2)
        tm = t + 0.5 * dt
        k2 = _ode_dx(score_fn, sde, x + 0.5 * dt * k1, tm)
        k3 = _ode_dx(score_fn, sde, x + 0.5 * dt * k2, tm)
        k4 = _ode_dx(score_fn, sde, x + dt * k3, t_next)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    def __call__(self, score_fn: Callable, x: torch.Tensor, pts_center: torch.Tensor,
                 return_process: bool = False):
        """x [rows, pose_dim], read and not written -> the camera-frame poses,
        or (trajectory [rows, num_steps, pose_dim] from x on, poses)."""
        ts, xs = self.ts, [x]
        for i in range(self.num_steps - 1):
            x = self._step(score_fn, x, ts[i], ts[i + 1])
            if return_process:
                xs.append(x)
        x = _denoise(score_fn, self.sde, x, (1.0 - self.sde.eps) / self.num_steps, self.eps)
        out = _finish(x, self.pose_mode, pts_center)
        if return_process:
            return _finish_process(xs, self.pose_mode, pts_center), out
        return out


def ode_sampler(score_fn: Callable, batch_size: int, sde: SDE, pose_mode: str = "rot_matrix",
                num_steps: int = 500, T0: Optional[float] = None,
                init_x: Optional[torch.Tensor] = None, pts_center: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device=None,
                integrator: str = "heun", return_process: bool = False):
    """Fixed-step PF-ODE sampler.  Returns x [batch_size, pose_dim] in the
    camera frame, or (trajectory [batch_size, num_steps, pose_dim], x)."""
    T = sde.T if T0 is None else T0
    device = _sampler_device(device, pts_center, generator)
    if pts_center is None:
        pts_center = torch.zeros((batch_size, 3), device=device)
    x = prior_rows(sde, batch_size, pose_mode, T, generator, device, init_x)
    chain = ODEChain(sde, pose_mode, num_steps, T, x.device, integrator)
    return chain(score_fn, x, pts_center, return_process)


# Dormand-Prince 5(4) tableau (scipy's RK45)
_DP_C = (0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0)
_DP_A = (
    (),
    (1.0 / 5,),
    (3.0 / 40, 9.0 / 40),
    (44.0 / 45, -56.0 / 15, 32.0 / 9),
    (19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729),
    (9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656),
)
_DP_B = (35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84)
# error coefficients incl. the FSAL 7th stage
_DP_E = (71.0 / 57600, 0.0, -71.0 / 16695, 71.0 / 1920, -17253.0 / 339200,
         22.0 / 525, -1.0 / 40)

_RK_SAFETY, _RK_MIN_FACTOR, _RK_MAX_FACTOR = 0.9, 0.2, 10.0
# the reference's solve_ivp tolerances, and the bound on step attempts
_ATOL = _RTOL = 1e-5
_MAX_STEPS = 2000


def _lincomb(coefs, ks):
    """sum(a * k) in the JAX package's order: Python ``sum`` starting from 0."""
    acc = 0
    for a, k in zip(coefs, ks):
        acc = acc + a * k
    return acc


def _mean_sq(v: torch.Tensor) -> torch.Tensor:
    return torch.mean(v ** 2)


class RK45:
    """Dormand-Prince RK45 with scipy's controller, backward from T to eps,
    over ``rows`` poses: ``start`` selects the initial step, each
    ``attempt`` takes one step of size -h and accepts or rejects it on the
    device, ``finish`` denoises and re-projects.  The state ``t, x, f, h,
    rejected, done`` lives in tensors made here, which the phases write in
    place.

    Each RMS norm is over every row of the integration, so ``start`` and
    ``attempt`` are split into phases (``start_phases``, ``attempt_phases``)
    at the norms: a phase leaves its rows' mean squares in ``ms`` and
    ``reduce`` makes them means over every rank's rows inside
    ``parallel.sharded`` (nothing elsewhere), so that each rank takes the
    step size a single process takes over the global batch (JAX keeps the
    mean global under its mesh).  The frozen programs capture each phase
    as a graph and call ``reduce`` between them, outside any graph."""

    # the slots of ``ms`` each phase of ``start`` / ``attempt`` leaves for the next
    START_SLOTS = ((0, 2), (2, 3))
    ATTEMPT_SLOTS = ((3, 4),)

    def __init__(self, sde: SDE, pose_mode: str, T: float, rows: int, device):
        self.sde, self.pose_mode, self.T, self.rows = sde, pose_mode, T, rows
        self.T_t = _scalar(T, device)
        self.eps_t = _scalar(sde.eps, device)
        self.h_min0 = _scalar(1e-6, device)
        self.h_max0 = _scalar(T - sde.eps, device)
        self.max_factor = _scalar(_RK_MAX_FACTOR, device)
        shape = (rows, get_pose_dim(pose_mode))
        self.x = torch.zeros(shape, device=device)
        self.f = torch.zeros(shape, device=device)
        self.x_new = torch.zeros(shape, device=device)
        self.f_new = torch.zeros(shape, device=device)
        self.t = _scalar(T, device)
        self.h = _scalar(0.0, device)
        self.h_try = _scalar(0.0, device)
        # mean squares: x0/scale0, f0/scale0, (f1 - f0)/scale0, the step's error
        self.ms = torch.zeros(4, device=device)
        self.rejected = torch.zeros((), dtype=torch.bool, device=device)
        self.done = torch.zeros((), dtype=torch.bool, device=device)

    def _dx(self, score_fn, x, t):
        return _ode_dx(score_fn, self.sde, x, t)

    def reduce(self, lo: int, hi: int) -> None:
        parallel.mean_over_rows_(self.ms[lo:hi], self.rows)

    def _scale0(self):
        return _ATOL + _RTOL * torch.abs(self.x)

    def start_a(self, score_fn: Callable, x0: torch.Tensor) -> None:
        """scipy's ``_select_initial_step`` (direction -1) from x0 at T, part 1."""
        f0 = self._dx(score_fn, x0, self.T_t)
        self.x.copy_(x0)
        self.f.copy_(f0)
        scale0 = self._scale0()
        self.ms[0:2].copy_(torch.stack([_mean_sq(x0 / scale0), _mean_sq(f0 / scale0)]))

    def start_b(self, score_fn: Callable) -> None:
        x0, f0, scale0 = self.x, self.f, self._scale0()
        d0, d1 = torch.sqrt(self.ms[0]), torch.sqrt(self.ms[1])
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), self.h_min0, 0.01 * d0 / d1)
        self.h_try.copy_(h0)
        y1 = x0 - h0 * f0  # backward direction
        f1 = self._dx(score_fn, y1, self.T - h0)
        self.ms[2].copy_(_mean_sq((f1 - f0) / scale0))

    def start_c(self) -> None:
        h0 = self.h_try
        d1 = torch.sqrt(self.ms[1])
        d2 = torch.sqrt(self.ms[2]) / h0
        h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                         torch.clamp(h0 * 1e-3, min=1e-6),
                         (0.01 / torch.maximum(d1, d2)) ** 0.2)
        self.h.copy_(torch.minimum(torch.minimum(100.0 * h0, h1), self.h_max0))
        self.t.copy_(self.T_t)
        self.rejected.fill_(False)
        self.done.fill_(False)

    def attempt_a(self, score_fn: Callable) -> None:
        """One DP45 step of size -h (never past eps), part 1: the stages,
        the new state and the mean square of its scaled error."""
        eps = self.sde.eps
        x, f, t = self.x, self.f, self.t
        h = torch.minimum(self.h, t - eps)
        ks = [f]
        for i in range(1, 6):
            ks.append(self._dx(score_fn, x - h * _lincomb(_DP_A[i], ks), t - _DP_C[i] * h))
        x_new = x - h * _lincomb(_DP_B, ks)
        f_new = self._dx(score_fn, x_new, t - h)  # FSAL stage
        err = _lincomb(_DP_E, ks + [f_new]) * (-h)
        scale = _ATOL + _RTOL * torch.maximum(torch.abs(x), torch.abs(x_new))
        self.ms[3].copy_(_mean_sq(err / scale))
        self.x_new.copy_(x_new)
        self.f_new.copy_(f_new)
        self.h_try.copy_(h)

    def attempt_b(self) -> None:
        """Part 2: accepted if the RMS error is at most 1; h grows or shrinks
        by scipy's factor."""
        eps, t, h = self.sde.eps, self.t, self.h_try
        err = torch.sqrt(self.ms[3])
        accept = err <= 1.0
        factor = torch.where(
            err == 0.0, self.max_factor,
            torch.clamp(_RK_SAFETY * err ** -0.2, _RK_MIN_FACTOR, _RK_MAX_FACTOR))
        factor = torch.where(accept & self.rejected, torch.clamp(factor, max=1.0), factor)
        self.done.copy_(accept & (t - h <= eps + 1e-12))
        self.t.copy_(torch.where(accept, t - h, t))
        self.x.copy_(torch.where(accept, self.x_new, self.x))
        self.f.copy_(torch.where(accept, self.f_new, self.f))
        self.h.copy_(h * factor)
        self.rejected.copy_(~accept)

    def start_phases(self, score_fn: Callable, x0: torch.Tensor):
        return [lambda: self.start_a(score_fn, x0), lambda: self.start_b(score_fn),
                self.start_c]

    def attempt_phases(self, score_fn: Callable):
        return [lambda: self.attempt_a(score_fn), self.attempt_b]

    def chain(self, phases, slots) -> Callable:
        """One call of ``phases`` in order, ``reduce`` of each slot range of
        ``slots`` after the phase it follows."""
        def run():
            for i, phase in enumerate(phases):
                phase()
                if i < len(slots):
                    self.reduce(*slots[i])
        return run

    def start(self, score_fn: Callable, x0: torch.Tensor) -> None:
        self.chain(self.start_phases(score_fn, x0), self.START_SLOTS)()

    def attempt(self, score_fn: Callable) -> None:
        self.chain(self.attempt_phases(score_fn), self.ATTEMPT_SLOTS)()

    def finish(self, score_fn: Callable, pts_center: torch.Tensor) -> torch.Tensor:
        # the reference's adaptive denoise step is (1-eps)/1000 (samplers.py:216)
        x = _denoise(score_fn, self.sde, self.x, (1.0 - self.sde.eps) / 1000.0, self.eps_t)
        return _finish(x, self.pose_mode, pts_center)


def integrate_adaptive(start: Callable, attempt: Callable, finish: Callable,
                       done: torch.Tensor):
    """The host's loop over RK45 attempts: ``start()``, then ``attempt()``
    until ``done`` (one host read per attempt) or ``_MAX_STEPS`` attempts,
    then ``finish()``.  Returns (finish's result, attempts made)."""
    start()
    n = 0
    while n < _MAX_STEPS:
        attempt()
        n += 1
        if bool(done):  # the one host read of the attempt
            break
    return finish(), n


def ode_sampler_adaptive(score_fn: Callable, batch_size: int, sde: SDE,
                         pose_mode: str = "rot_matrix", T0: Optional[float] = None,
                         init_x: Optional[torch.Tensor] = None,
                         pts_center: Optional[torch.Tensor] = None, return_stats: bool = False,
                         generator: Optional[torch.Generator] = None, device=None):
    """Adaptive PF-ODE sampler: Dormand-Prince RK45 with scipy's controller.

    scipy semantics: RMS error norm over the whole flattened batch state with
    scale ``atol + rtol * max(|y|, |y_new|)`` (one step size for the batch),
    the Hairer initial step, FSAL, factor clamps [0.2, 10] with safety 0.9,
    and no growth right after a rejection.  If ``_MAX_STEPS`` attempts run out
    the mid-trajectory state is returned as it is (the reference does not
    check ``solve_ivp``'s status either).

    Returns x [batch_size, pose_dim], or (x, {"n_steps", "t_final",
    "converged"}) with ``return_stats``.
    """
    T = sde.T if T0 is None else T0
    device = _sampler_device(device, pts_center, generator)
    if pts_center is None:
        pts_center = torch.zeros((batch_size, 3), device=device)
    x0 = prior_rows(sde, batch_size, pose_mode, T, generator, device, init_x)
    rk = RK45(sde, pose_mode, T, batch_size, x0.device)
    x, n = integrate_adaptive(lambda: rk.start(score_fn, x0), lambda: rk.attempt(score_fn),
                              lambda: rk.finish(score_fn, pts_center), rk.done)
    if return_stats:
        return x, {"n_steps": n, "t_final": float(rk.t), "converged": bool(rk.done)}
    return x


def _block_normalize(x: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """PC's per-step normalisation (ref ``samplers.py:134-143``): unit-norm
    quaternion; ``euler_xyz`` unchanged; else unit-norm 3-blocks over the
    first six entries (the 6D columns, and for ``euler_xyz_sx_cx`` the sines
    and the cosines, as the JAX sampler does)."""
    if pose_mode in ("quat_wxyz", "quat_xyzw"):
        return torch.cat([x[:, :4] / torch.linalg.norm(x[:, :4], dim=-1, keepdim=True),
                          x[:, 4:]], dim=-1)
    if pose_mode == "euler_xyz":
        return x
    r1 = x[:, :3] / torch.linalg.norm(x[:, :3], dim=-1, keepdim=True)
    r2 = x[:, 3:6] / torch.linalg.norm(x[:, 3:6], dim=-1, keepdim=True)
    return torch.cat([r1, r2, x[:, 6:]], dim=-1)


def pc_start(sde: SDE, batch_size: int, pose_mode: str, T0: Optional[float],
             generator: Optional[torch.Generator], device,
             init_x: Optional[torch.Tensor] = None) -> Tuple[float, torch.Tensor]:
    """PC's start (T, x): without ``T0`` the full ladder from ``sde.T``
    from ``init_x`` as it is, else from a prior draw (the reference); with
    ``T0`` the prior at T0, added to ``init_x`` if given, as ``ode_sampler``."""
    if T0 is None:
        x = prior_rows(sde, batch_size, pose_mode, sde.T, generator, device) \
            if init_x is None else init_x
        return sde.T, x
    return T0, prior_rows(sde, batch_size, pose_mode, T0, generator, device, init_x)


def pc_draws(generator: Optional[torch.Generator], num_steps: int, shape, device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PC's per-step draws (corrector, predictor), each [num_steps, *shape]:
    one ``torch.randn((2, *shape))`` a step, in step order, as the loop of
    steps drew them.  One draw of [num_steps, 2, *shape] would give other
    numbers (on the card Philox advances its offset per call, rounded up;
    on the CPU ``normal_`` fills blocks of 16)."""
    draws = torch.empty((num_steps, 2, *shape), device=device)
    rows, rest = shape[0], tuple(shape[1:])
    for i in range(num_steps):
        draws[i] = parallel.local_draw(
            lambda n: torch.randn((2, n, *rest), generator=generator, device=device),
            rows, axis=1)
    return draws[:, 0], draws[:, 1]


class PCChain:
    """The predictor-corrector steps of ``pc_sampler`` over
    ``linspace(T, eps, num_steps)``, with the per-step draws taken from
    buffers.  The grid and the step are built here; a call launches device
    work only, so a CUDA graph can capture it whole."""

    def __init__(self, sde: SDE, pose_mode: str, num_steps: int, T: float, device,
                 snr: float = 0.16):
        self.sde, self.pose_mode, self.num_steps, self.snr = sde, pose_mode, num_steps, snr
        self.ts = _linspace(T, sde.eps, num_steps, device)
        self.step_size = self.ts[0] - self.ts[1]
        self.sqrt_step = torch.sqrt(self.step_size)
        self.noise_norm = math.sqrt(float(get_pose_dim(pose_mode)))

    def __call__(self, score_fn: Callable, x: torch.Tensor,
                 noise: Tuple[torch.Tensor, torch.Tensor], pts_center: torch.Tensor,
                 return_process: bool = False):
        """x [rows, pose_dim], read and not written; ``noise`` (corrector,
        predictor) [num_steps, rows, pose_dim] -> the camera-frame poses, or
        (trajectory [rows, num_steps, pose_dim], poses)."""
        sde, pose_mode, step_size = self.sde, self.pose_mode, self.step_size
        mean_x, xs = x, []
        for i in range(self.num_steps):
            t = self.ts[i]
            # corrector (Langevin MCMC)
            grad = _score(score_fn, x, t)
            grad_norm = parallel.mean_over_rows_(
                torch.mean(torch.linalg.norm(grad, dim=-1)), grad.shape[0])
            langevin_step = torch.where(
                grad_norm > 1e-8,
                2.0 * (self.snr * self.noise_norm / torch.clamp(grad_norm, min=1e-8)) ** 2, 0.0)
            x = x + langevin_step * grad + torch.sqrt(2.0 * langevin_step) * noise[0][i]
            x = _block_normalize(x, pose_mode)
            # predictor (Euler-Maruyama on the reverse SDE)
            drift, diffusion = sde.sde(t.reshape(1, 1))
            grad = _score(score_fn, x, t)
            mean_x = x + (diffusion ** 2 * grad - drift * x) * step_size
            x = mean_x + diffusion * self.sqrt_step * noise[1][i]
            x = torch.cat([normalize_rotation(x[:, :-3], pose_mode), x[:, -3:]], dim=-1)
            if return_process:
                xs.append(x)
        out = _finish(mean_x, pose_mode, pts_center)
        if return_process:
            traj = torch.stack(xs, dim=1)
            return torch.cat([traj[..., :-3], traj[..., -3:] + pts_center[:, None]], dim=-1), out
        return out


def pc_sampler(score_fn: Callable, batch_size: int, sde: SDE, pose_mode: str = "rot_matrix",
               num_steps: int = 500, snr: float = 0.16, T0: Optional[float] = None,
               init_x: Optional[torch.Tensor] = None, pts_center: Optional[torch.Tensor] = None,
               return_process: bool = False, generator: Optional[torch.Generator] = None,
               device=None, noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Predictor-corrector sampler (JAX ``samplers.py:274-381``; ref
    ``cond_pc_sampler``, ``samplers.py:102-160``).

    Per step of ``linspace(T, eps, num_steps)``: a Langevin corrector with
    the SNR-adaptive step 2 (snr sqrt(pose_dim) / mean |score|)^2, zero
    when the mean score norm is at most 1e-8 (a zero-initialised net would
    otherwise take an infinite step; decided on the device), then the
    per-block normalisation; then an Euler-Maruyama predictor on the
    reverse SDE with the score re-evaluated at the corrected x and the
    backward sign x + (g^2 s - f) dt (the JAX package's two fixes of the
    reference), then the rotation re-projection.  The answer is the last
    predictor mean, re-projected, with the centre added.  The corrector's
    step is a mean over all rows, so every row, padding included, is part
    of every other row's result.

    Start: ``pc_start``.  ``noise``: (corrector draws, predictor draws),
    each [num_steps, batch_size, pose_dim]; else ``pc_draws`` from
    ``generator`` after the prior.  Returns x [batch_size, pose_dim], or
    (trajectory [batch_size, num_steps, pose_dim], x).
    """
    device = _sampler_device(device, pts_center, generator)
    shape = (batch_size, get_pose_dim(pose_mode))
    T, x = pc_start(sde, batch_size, pose_mode, T0, generator, device, init_x)
    if pts_center is None:
        pts_center = torch.zeros((batch_size, 3), device=device)
    if noise is None:
        noise = pc_draws(generator, num_steps, shape, x.device)
    elif any(z.shape != (num_steps, *shape) for z in noise):
        raise ValueError(f"noise shapes {[tuple(z.shape) for z in noise]} do not fit "
                         f"{num_steps} steps of {shape}")
    chain = PCChain(sde, pose_mode, num_steps, T, x.device, snr)
    return chain(score_fn, x, noise, pts_center, return_process)


def ode_likelihood(score_fn: Callable, x: torch.Tensor, sde: SDE, pose_mode: str = "rot_matrix",
                   num_steps: int = 500, exact_divergence: bool = True,
                   epsilon: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """PF-ODE log-likelihood (JAX ``samplers.py:384-460``; ref
    ``cond_ode_likelihood``).

    Integrates the joint (x, log p) ODE with Heun from eps to T over
    ``linspace(eps, T, num_steps)``.  The divergence of the score is the
    exact trace, one backward pass per pose dimension (the JAX package's
    ``pose_dim`` basis-vector JVPs give the same diagonal: the rows are
    independent), or with ``exact_divergence=False`` the single-probe
    Hutchinson estimate eps^T J eps with the probe ``epsilon`` [bs,
    pose_dim] (else drawn N(0, I) from ``generator``).  ``score_fn`` must
    be differentiable in the pose (an energy model's score built with
    ``create_graph``).  x [bs, pose_dim], zero-centred translations.
    Returns (latent z [bs, pose_dim], log-likelihoods in bits [bs]).
    """
    bs, pose_dim = x.shape
    dev = x.device
    if not exact_divergence and epsilon is None:
        epsilon = parallel.local_draw(
            lambda n: torch.randn((n, pose_dim), generator=generator, device=dev), bs)
    ts = _linspace(sde.eps, sde.T, num_steps, dev)

    def dx_and_div(x, t):
        drift, diffusion = sde.sde(t)
        t_vec = t.reshape(1, 1).expand(bs, 1)
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            score = score_fn(xr, t_vec)
            if exact_divergence:
                div = 0
                for i in range(pose_dim):
                    (g,) = torch.autograd.grad(score[:, i].sum(), xr, retain_graph=True)
                    div = div + g[:, i]
            else:
                (g,) = torch.autograd.grad(torch.sum(score * epsilon), xr)
                div = torch.sum(g * epsilon, dim=-1)
        score, div = score.detach(), div.detach()
        # f(x) = c(t) x, so its divergence is pose_dim * c(t)
        dx = drift * x - 0.5 * diffusion ** 2 * score
        dlogp = pose_dim * drift - 0.5 * diffusion ** 2 * div
        return dx, dlogp

    logp = torch.zeros((bs,), device=dev)
    for i in range(num_steps - 1):
        t, t_next = ts[i], ts[i + 1]
        dt = t_next - t
        dx1, dlogp1 = dx_and_div(x, t)
        dx2, dlogp2 = dx_and_div(x + dt * dx1, t_next)
        x = x + dt * 0.5 * (dx1 + dx2)
        logp = logp + dt * 0.5 * (dlogp1 + dlogp2)
    _, sigma_max = sde.marginal_prob(None, _scalar(sde.T, dev))
    prior_logp = (-pose_dim / 2.0 * torch.log(2 * math.pi * sigma_max ** 2)
                  - torch.sum(x ** 2, dim=-1) / (2 * sigma_max ** 2))
    return x, (prior_logp + logp) / torch.log(_scalar(2.0, dev))


def edm_sigma_start(T0: Optional[float], sigma_min: float, sigma_max: float) -> float:
    """The start sigma of a run started at the time fraction ``T0`` in (0, 1]:
    sigma_min^(1-T0) sigma_max^T0, the VE marginal's interpolation (JAX
    ``samplers.py:498-505``, ``agent.py:480-493``); sigma_max for T0 None
    or >= 1."""
    if T0 is None or T0 >= 1.0:
        return sigma_max
    t0 = max(float(T0), 0.0)
    return sigma_min ** (1.0 - t0) * sigma_max ** t0


def edm_draws(generator: Optional[torch.Generator], shape, num_steps: int, churn: bool,
              device, latents: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None):
    """EDM's draws (latents [*shape], churn noise [num_steps, *shape] or
    None): each one not given is drawn from ``generator``, the latents
    first, then one ``torch.randn(shape)`` a step, as the loop of steps drew
    them; without churn (``S_churn`` = 0, the default) no noise is drawn."""
    rows, rest = shape[0], tuple(shape[1:])

    def draw(n):
        return torch.randn((n, *rest), generator=generator, device=device)

    if latents is None:
        latents = parallel.local_draw(draw, rows)
    if churn and noise is None:
        noise = torch.empty((num_steps, *shape), device=device)
        for n in range(num_steps):
            noise[n] = parallel.local_draw(draw, rows)
    return latents, (noise if churn else None)


class EDMChain:
    """The Heun steps of ``edm_sampler`` on the Karras ladder from the start
    sigma of ``T0``, with the draws taken from buffers.  The ladder is built
    here; a call launches device work only, so a CUDA graph can capture it
    whole."""

    def __init__(self, pose_mode: str, num_steps: int, device, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, rho: float = 7.0, S_churn: float = 0.0,
                 S_min: float = 0.0, S_max: float = float("inf"), S_noise: float = 1.0,
                 T0: Optional[float] = None):
        if num_steps < 2:
            raise ValueError(f"edm_sampler needs num_steps >= 2, got {num_steps}")
        self.pose_mode, self.num_steps = pose_mode, num_steps
        self.S_min, self.S_max, self.S_noise = S_min, S_max, S_noise
        start = edm_sigma_start(T0, sigma_min, sigma_max)
        i = torch.arange(num_steps, dtype=torch.float32, device=device)
        a, b = start ** (1 / rho), sigma_min ** (1 / rho)
        t_steps = (a + i / (num_steps - 1) * (b - a)) ** rho
        self.t_steps = torch.cat([t_steps, torch.zeros(1, device=device)])
        self.gamma_base = min(S_churn / num_steps, math.sqrt(2.0) - 1.0)

    @property
    def churn(self) -> bool:
        return self.gamma_base > 0

    def __call__(self, denoise_fn: Callable, latents: torch.Tensor, pts_center: torch.Tensor,
                 init_x: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 return_process: bool = False):
        """latents [rows, pose_dim] (unit), ``noise`` [num_steps, rows,
        pose_dim] under churn -> the camera-frame poses, or (trajectory
        [rows, num_steps, pose_dim], poses)."""
        t_steps = self.t_steps
        x = latents * t_steps[0]
        if init_x is not None:
            x = init_x + x
        xs = []
        for n in range(self.num_steps):
            t_cur, t_next = t_steps[n], t_steps[n + 1]
            x_hat, t_hat = x, t_cur
            if self.churn:
                in_range = (t_cur >= self.S_min) & (t_cur <= self.S_max)
                t_hat = t_cur + torch.where(in_range, self.gamma_base, 0.0) * t_cur
                x_hat = x + torch.sqrt(torch.clamp(t_hat ** 2 - t_cur ** 2, min=0.0)) \
                    * self.S_noise * noise[n]
            d_cur = (x_hat - denoise_fn(x_hat, t_hat.reshape(1, 1))) / t_hat
            x = x_hat + (t_next - t_hat) * d_cur
            if n < self.num_steps - 1:
                d_prime = (x - denoise_fn(x, t_next.reshape(1, 1))) / t_next
                x = x_hat + (t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
            if return_process:
                xs.append(x)
        out = _finish(x, self.pose_mode, pts_center)
        if return_process:
            return _finish_process(xs, self.pose_mode, pts_center), out
        return out


def edm_sampler(denoise_fn: Callable, batch_size: int, pose_mode: str = "rot_matrix",
                num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
                rho: float = 7.0, S_churn: float = 0.0, S_min: float = 0.0,
                S_max: float = float("inf"), S_noise: float = 1.0,
                pts_center: Optional[torch.Tensor] = None, return_process: bool = False,
                T0: Optional[float] = None, init_x: Optional[torch.Tensor] = None,
                latents: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device=None,
                noise: Optional[torch.Tensor] = None):
    """EDM Heun sampler (JAX ``samplers.py:462-564``; ref ``cond_edm_sampler``).

    The Karras ladder sigma_i = (s^(1/rho) + i/(n-1) (sigma_min^(1/rho) -
    s^(1/rho)))^rho from the start sigma s (``edm_sigma_start(T0)``) down
    to sigma_min, then 0; each step an Euler step on dx/dsigma = (x -
    D(x, sigma)) / sigma with Heun's correction except the last, so
    2 num_steps - 1 denoiser evaluations.  The start is ``latents`` (a unit
    draw [batch_size, pose_dim], else from ``generator``) times s, added to
    ``init_x`` if given.  With ``S_churn`` > 0 each step first adds noise
    (``noise`` [num_steps, batch_size, pose_dim], else drawn); at the
    default 0 the churn adds exactly nothing and nothing is drawn
    (``edm_draws``).  Returns x [batch_size, pose_dim], or (trajectory
    [batch_size, num_steps, pose_dim], x).
    """
    device = _sampler_device(device, pts_center, generator)
    chain = EDMChain(pose_mode, num_steps, device, sigma_min, sigma_max, rho, S_churn, S_min,
                     S_max, S_noise, T0)
    if pts_center is None:
        pts_center = torch.zeros((batch_size, 3), device=device)
    latents, noise = edm_draws(generator, (batch_size, get_pose_dim(pose_mode)), num_steps,
                               chain.churn, device, latents, noise)
    return chain(denoise_fn, latents, pts_center, init_x, noise, return_process)
