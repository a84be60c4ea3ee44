"""PF-ODE samplers (counterpart of ``genpose_tpu/diffusion/samplers.py``).

- ``ode_sampler``: fixed-step Heun over ``linspace(T, eps, num_steps)``, the
  config default ``sampler_mode=("ode",)`` (JAX ``samplers.py:45-123``).
- ``ode_sampler_adaptive``: Dormand-Prince RK45 with scipy's step
  controller, one step size for the whole flattened batch, at most
  2000 attempts and a final denoise step (JAX ``samplers.py:145-271``; reference
  ``cond_ode_sampler``, which runs scipy ``solve_ivp`` at atol/rtol 1e-5).

Both take ``score_fn(pose, t) -> score`` closed over the encoded cloud, and
draw the prior from ``sde.prior`` with an explicit ``torch.Generator``.
With ``init_x`` (tracking: the previous frame's pose, started at a reduced
``T0``) the integration starts from ``init_x + prior`` (JAX
``samplers.py:69,189``; reference ``samplers.py:180``).

The integration itself lives in ``HeunChain`` and ``RK45``, which the two
functions above run eagerly and ``training/frozen.py`` captures in CUDA
graphs.  Each builds its constants (the time grid, eps, the step bounds) as
device tensors when it is made, outside any capture, and then launches
device work only.  ``RK45`` keeps its state ``t, x, f, h, rejected, done``
in tensors of its own that each attempt updates in place; its accept/reject
control lives on the device, as in the JAX ``while_loop``, and the host
reads one flag per attempt to decide whether to stop
(``integrate_adaptive``).

The state stays float32 under a bfloat16 compute dtype: the heads return
float32 scores (JAX promotes the same way), and ``_score`` refuses any
other, since a bfloat16 score times a 0-dim float32 coefficient would stay
bfloat16 in PyTorch and round the step silently.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from genpose_tpu_torch.diffusion.sde import SDE
from genpose_tpu_torch.ops.pose import get_pose_dim, normalize_rotation
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
    """The start of the integration: a prior draw at T, added to ``init_x`` if given."""
    x = sde.prior((batch_size, get_pose_dim(pose_mode)), T=T, generator=generator,
                  device=device)
    return x if init_x is None else init_x + x


class HeunChain:
    """Heun's integration from T to eps in ``num_steps - 1`` steps, then the
    denoise step and the re-projection.  ``ts`` and eps are built here; a
    call launches device work only, so a CUDA graph can capture it whole."""

    def __init__(self, sde: SDE, pose_mode: str, num_steps: int, T: float, device):
        self.sde, self.pose_mode, self.num_steps = sde, pose_mode, num_steps
        self.ts = _linspace(T, sde.eps, num_steps, device)
        self.eps = _scalar(sde.eps, device)

    def __call__(self, score_fn: Callable, x: torch.Tensor,
                 pts_center: torch.Tensor) -> torch.Tensor:
        """x [rows, pose_dim], read and not written -> the camera-frame poses."""
        ts, sde = self.ts, self.sde
        for i in range(self.num_steps - 1):
            t, t_next = ts[i], ts[i + 1]
            dt = t_next - t
            k1 = _ode_dx(score_fn, sde, x, t)
            x_pred = x + dt * k1
            k2 = _ode_dx(score_fn, sde, x_pred, t_next)
            x = x + dt * 0.5 * (k1 + k2)
        x = _denoise(score_fn, sde, x, (1.0 - sde.eps) / self.num_steps, self.eps)
        return _finish(x, self.pose_mode, pts_center)


def ode_sampler(score_fn: Callable, batch_size: int, sde: SDE, pose_mode: str = "rot_matrix",
                num_steps: int = 500, T0: Optional[float] = None,
                init_x: Optional[torch.Tensor] = None, pts_center: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Heun PF-ODE sampler.  Returns x [batch_size, pose_dim] in the camera frame."""
    T = sde.T if T0 is None else T0
    device = _sampler_device(device, pts_center, generator)
    if pts_center is None:
        pts_center = torch.zeros((batch_size, 3), device=device)
    x = prior_rows(sde, batch_size, pose_mode, T, generator, device, init_x)
    return HeunChain(sde, pose_mode, num_steps, T, x.device)(score_fn, x, pts_center)


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


def _rms(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(v ** 2))


class RK45:
    """Dormand-Prince RK45 with scipy's controller, backward from T to eps,
    over ``rows`` poses: ``start`` selects the initial step, each
    ``attempt`` takes one step of size -h and accepts or rejects it on the
    device, ``finish`` denoises and re-projects.  The state ``t, x, f, h,
    rejected, done`` lives in tensors made here, which ``start`` and
    ``attempt`` write in place."""

    def __init__(self, sde: SDE, pose_mode: str, T: float, rows: int, device):
        self.sde, self.pose_mode, self.T = sde, pose_mode, T
        self.T_t = _scalar(T, device)
        self.eps_t = _scalar(sde.eps, device)
        self.h_min0 = _scalar(1e-6, device)
        self.h_max0 = _scalar(T - sde.eps, device)
        self.max_factor = _scalar(_RK_MAX_FACTOR, device)
        shape = (rows, get_pose_dim(pose_mode))
        self.x = torch.zeros(shape, device=device)
        self.f = torch.zeros(shape, device=device)
        self.t = _scalar(T, device)
        self.h = _scalar(0.0, device)
        self.rejected = torch.zeros((), dtype=torch.bool, device=device)
        self.done = torch.zeros((), dtype=torch.bool, device=device)

    def _dx(self, score_fn, x, t):
        return _ode_dx(score_fn, self.sde, x, t)

    def start(self, score_fn: Callable, x0: torch.Tensor) -> None:
        """scipy's ``_select_initial_step`` (direction -1) from x0 at T."""
        T, atol, rtol = self.T, _ATOL, _RTOL
        f0 = self._dx(score_fn, x0, self.T_t)
        scale0 = atol + rtol * torch.abs(x0)
        d0 = _rms(x0 / scale0)
        d1 = _rms(f0 / scale0)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), self.h_min0, 0.01 * d0 / d1)
        y1 = x0 - h0 * f0  # backward direction
        f1 = self._dx(score_fn, y1, T - h0)
        d2 = _rms((f1 - f0) / scale0) / h0
        h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                         torch.clamp(h0 * 1e-3, min=1e-6),
                         (0.01 / torch.maximum(d1, d2)) ** 0.2)
        self.h.copy_(torch.minimum(torch.minimum(100.0 * h0, h1), self.h_max0))
        self.t.copy_(self.T_t)
        self.x.copy_(x0)
        self.f.copy_(f0)
        self.rejected.fill_(False)
        self.done.fill_(False)

    def attempt(self, score_fn: Callable) -> None:
        """One DP45 step of size -h (never past eps), accepted if its RMS
        error is at most 1; h grows or shrinks by scipy's factor."""
        eps, atol, rtol = self.sde.eps, _ATOL, _RTOL
        x, f, t = self.x, self.f, self.t
        h = torch.minimum(self.h, t - eps)
        ks = [f]
        for i in range(1, 6):
            ks.append(self._dx(score_fn, x - h * _lincomb(_DP_A[i], ks), t - _DP_C[i] * h))
        x_new = x - h * _lincomb(_DP_B, ks)
        f_new = self._dx(score_fn, x_new, t - h)  # FSAL stage
        err = _lincomb(_DP_E, ks + [f_new]) * (-h)
        scale = atol + rtol * torch.maximum(torch.abs(x), torch.abs(x_new))
        err = _rms(err / scale)
        accept = err <= 1.0
        factor = torch.where(
            err == 0.0, self.max_factor,
            torch.clamp(_RK_SAFETY * err ** -0.2, _RK_MIN_FACTOR, _RK_MAX_FACTOR))
        factor = torch.where(accept & self.rejected, torch.clamp(factor, max=1.0), factor)
        self.done.copy_(accept & (t - h <= eps + 1e-12))
        self.t.copy_(torch.where(accept, t - h, t))
        self.x.copy_(torch.where(accept, x_new, x))
        self.f.copy_(torch.where(accept, f_new, f))
        self.h.copy_(h * factor)
        self.rejected.copy_(~accept)

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
