"""Training state: optimizer, learning-rate schedule and EMA shadow
(counterpart of ``genpose_tpu/training/state.py``).

The update follows the JAX package's optax chain step for step, not
PyTorch's optimizers:

- the schedule is read with the update count *before* the increment, so
  the first update runs at ``make_lr_schedule(0) = 0`` (the params stay as
  they are while the optimizer moments, the step and the EMA count
  advance);
- clip by global norm: gradients are scaled by ``max_norm / norm`` when the
  norm is at least ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6 to the norm);
- Adam (b1 0.9, b2 0.999, eps 1e-8): bias-corrected moments, eps outside
  the square root, ``p += -lr * m_hat / (sqrt(v_hat) + eps)``;
- SGD: weight decay 1e-4, then momentum 0.9 (``g + 0.9 * trace``), then the
  step.  The JAX package masks the decay off the Fourier ``W``; here ``W``
  is a buffer, not a parameter, so no update reaches it;
- EMA: ``shadow -= (1 - d) * (shadow - p)`` with
  ``d = min(decay, (1 + n) / (10 + n))``, after every update.

Scalars that the JAX package computes in float32 (the schedule, bias
corrections, EMA decay) are computed in numpy float32 here.  Parameters are
updated in place, by multi-tensor ops (``torch._foreach_*``: a handful of
launches a step on a card, where one per tensor and operation made the
update ~10 ms of a step) that do the per-tensor arithmetic element for
element (``tests/test_torch_trainer.py`` holds them bit for bit).
Optimizer moments and the EMA shadow are created at the first update, so
an agent that only serves holds neither; until then the shadow *is* the
live parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from genpose_tpu_torch.utils import trace

f32 = np.float32


def make_lr_schedule(base_lr: float, warmup_steps: int, decay_per_epoch: float,
                     steps_per_epoch: int, floor_lr: float = 1e-4) -> Callable[[int], float]:
    """lr(step) = base * min(step / warmup, 1) * gamma^min(epoch, floor_epochs)
    (reference ``posenet_agent.py:543-550``, per-epoch decay frozen below the floor)."""
    if not 0.0 < decay_per_epoch <= 1.0:
        raise ValueError(f"decay_per_epoch must be in (0, 1], got {decay_per_epoch}")
    if decay_per_epoch == 1.0:  # decay disabled (log(1) = 0 would divide by 0)
        floor_epochs = 0
    else:
        floor_epochs = max(0, math.ceil(math.log(floor_lr / base_lr) /
                                        math.log(decay_per_epoch)))

    def schedule(step: int) -> float:
        s = f32(step)
        warm = np.minimum(s / f32(max(warmup_steps, 1)), f32(1.0))
        n_decay = np.minimum(np.floor(s / f32(steps_per_epoch)), f32(floor_epochs))
        return float(f32(base_lr) * warm * f32(decay_per_epoch) ** n_decay)

    return schedule


class EMA:
    """Shadow parameters (reference ``score_utils.py:3-92``); ``shadow`` None
    means "equal to the live parameters"."""

    def __init__(self, decay: float, shadow: Optional[Dict[str, torch.Tensor]] = None,
                 num_updates: int = 0):
        self.decay = decay
        self.shadow = shadow
        self.num_updates = num_updates

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor]) -> None:
        n = self.num_updates + 1
        decay = np.minimum(f32(self.decay), (f32(1.0) + f32(n)) / (f32(10.0) + f32(n)))
        rate = float(f32(1.0) - decay)
        shadow = [self.shadow[k] for k in params]
        torch._foreach_sub_(shadow, torch._foreach_mul(
            torch._foreach_sub(shadow, list(params.values())), rate))
        self.num_updates = n


def _params_device(state, params: Mapping[str, torch.Tensor], grads) -> torch.device:
    """The device of an update's span: the parameters'."""
    return next(iter(params.values())).device


class TrainState:
    """Step count, optimizer state and EMA of one agent's parameters.

    ``apply_gradients(params, grads)`` takes the live parameters by name
    (``dict(model.named_parameters())``) and their gradients, and updates
    the parameters, the optimizer state, the step and the EMA.
    """

    def __init__(self, schedule: Callable[[int], float], optimizer: str = "Adam",
                 grad_clip: float = 1.0, ema_rate: float = 0.999):
        if optimizer not in ("Adam", "SGD"):
            raise NotImplementedError(optimizer)
        self.schedule = schedule
        self.optimizer = optimizer
        self.grad_clip = grad_clip
        self.step = 0
        # Adam: {"mu": {...}, "nu": {...}}; SGD: {"trace": {...}}; None before the first update
        self.opt_state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.ema = EMA(ema_rate)

    def _init_opt_state(self, params: Mapping[str, torch.Tensor]):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return ({"mu": zeros(), "nu": zeros()} if self.optimizer == "Adam"
                else {"trace": zeros()})

    @trace.spanned("optimizer", device=_params_device)
    @torch.no_grad()
    def apply_gradients(self, params: Mapping[str, torch.Tensor],
                        grads: Mapping[str, torch.Tensor]) -> None:
        if set(grads) != set(params):
            raise ValueError("gradients and parameters must have the same names")
        if self.ema.shadow is None:  # the shadow starts as the params before the update
            self.ema.shadow = {k: p.detach().clone() for k, p in params.items()}
        if self.opt_state is None:
            self.opt_state = self._init_opt_state(params)
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        if self.grad_clip and self.grad_clip > 0:
            # a select on the device, not a branch on the host: no sync per
            # step.  Kept gradients are divided and multiplied by 1, exactly.
            norm = torch.sqrt(sum(torch.sum(sq) for sq in torch._foreach_mul(gs, gs)))
            keep = norm < self.grad_clip
            one = torch.ones_like(norm)
            gs = torch._foreach_mul(torch._foreach_div(gs, torch.where(keep, one, norm)),
                                    torch.where(keep, one, one * self.grad_clip))
        lr = self.schedule(self.step)
        count = self.step + 1
        if self.optimizer == "Adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            c1 = float(f32(1.0) - f32(b1) ** f32(count))
            c2 = float(f32(1.0) - f32(b2) ** f32(count))
            mu = [self.opt_state["mu"][k] for k in names]
            nu = [self.opt_state["nu"][k] for k in names]
            mu = torch._foreach_add(torch._foreach_mul(gs, 1 - b1), torch._foreach_mul(mu, b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                                    torch._foreach_mul(nu, b2))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(denom, eps)
            update = torch._foreach_div(torch._foreach_div(mu, c1), denom)
            self.opt_state["mu"].update(zip(names, mu))
            self.opt_state["nu"].update(zip(names, nu))
        else:
            trace = [self.opt_state["trace"][k] for k in names]
            # weight decay, then momentum
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, 1e-4))
            update = torch._foreach_add(gs, torch._foreach_mul(trace, 0.9))
            self.opt_state["trace"].update(zip(names, update))
        torch._foreach_add_(ps, torch._foreach_mul(update, -lr))
        self.step = count
        self.ema.update(params)


def create_train_state(base_lr: float = 1e-3, warmup_steps: int = 100,
                       decay_per_epoch: float = 0.98, steps_per_epoch: int = 1000,
                       floor_lr: float = 1e-4, grad_clip: float = 1.0, ema_rate: float = 0.999,
                       optimizer: str = "Adam",
                       lr_schedule: Optional[Callable[[int], float]] = None) -> TrainState:
    """A TrainState with the reference's recipe (``configs/config.py:50-62``,
    ``scripts/train_score.sh``); ``lr_schedule`` replaces the schedule."""
    schedule = lr_schedule or make_lr_schedule(base_lr, warmup_steps, decay_per_epoch,
                                               steps_per_epoch, floor_lr)
    return TrainState(schedule, optimizer=optimizer, grad_clip=grad_clip, ema_rate=ema_rate)
