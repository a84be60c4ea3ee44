"""SDE schedules: VE, VP, sub-VP and EDM (counterpart of ``genpose_tpu/diffusion/sde.py``).

Reference ``networks/gf_algorithms/sde.py:13-116`` with its hyperparameters:
VE sigma in [0.01, 50], eps=1e-5, T=1.0 (the schedule of every released
GenPose checkpoint); VP and sub-VP beta in [0.1, 20], eps=1e-3, T=1.0; EDM
sigma in [0.002, 80], where the "time" is sigma itself (eps=0.002, T=80).

``marginal_prob(x, t)`` returns (mean, std); ``x=None`` asks for the std
only (the heads' sigma(t)), and the mean is then None where it depends on
x.  ``sde(t)`` returns the drift COEFFICIENT c(t) of f(x, t) = c(t) x and
the diffusion g(t).  ``prior`` draws from an explicit ``torch.Generator``
or scales an injected standard-normal tensor, so tests can feed both
packages the same noise; each prior takes the start time ``T`` (VE: sigma
at time T; EDM: T is the start sigma; VP and sub-VP: unit variance).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SDE:
    """Bundle of schedule functions (reference ``init_sde``, ``sde.py:80-116``)."""

    mode: str
    prior: Callable  # (shape, T=..., generator=None, device=None, noise=None) -> x
    marginal_prob: Callable  # (x, t) -> (mean, std)
    sde: Callable  # (t) -> (drift_coeff, diffusion_coeff)
    eps: float
    T: float


def _normal(shape: Sequence[int], generator: Optional[torch.Generator], device,
            noise: Optional[torch.Tensor]) -> torch.Tensor:
    """``noise`` if given, else a standard-normal draw from ``generator``."""
    if noise is not None:
        return noise
    if generator is not None:
        device = generator.device
    return torch.randn(tuple(shape), generator=generator, device=device)


# ----- VE (reference sde.py:15-28) -----

def ve_marginal_prob(x, t, sigma_min=0.01, sigma_max=50.0):
    std = sigma_min * (sigma_max / sigma_min) ** t
    return x, std


def ve_sde(t: torch.Tensor, sigma_min=0.01, sigma_max=50.0):
    sigma = sigma_min * (sigma_max / sigma_min) ** t
    drift = torch.zeros_like(sigma)
    # the JAX schedule's float32 chain: sqrt(2 * (log smax - log smin))
    f32 = np.float32
    g = float(np.sqrt(f32(2.0) * (np.log(f32(sigma_max)) - np.log(f32(sigma_min)))))
    return drift, sigma * g


def ve_prior(shape: Sequence[int], sigma_min=0.01, sigma_max=50.0, T=1.0,
             generator: Optional[torch.Generator] = None,
             device=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sigma(T) * z with z ~ N(0, I) drawn from ``generator``, or ``noise``."""
    _, sigma_T = ve_marginal_prob(None, T, sigma_min, sigma_max)
    return _normal(shape, generator, device, noise) * sigma_T


# ----- VP (reference sde.py:32-45) -----

def _log_mean_coeff(t, beta_0, beta_1):
    t = torch.as_tensor(t, dtype=torch.float32)
    return -0.25 * t ** 2 * (beta_1 - beta_0) - 0.5 * t * beta_0


def vp_marginal_prob(x, t, beta_0=0.1, beta_1=20.0):
    lmc = _log_mean_coeff(t, beta_0, beta_1)
    mean = None if x is None else torch.exp(lmc) * x
    return mean, torch.sqrt(1.0 - torch.exp(2.0 * lmc))


def vp_sde(t: torch.Tensor, beta_0=0.1, beta_1=20.0):
    beta_t = beta_0 + t * (beta_1 - beta_0)
    return -0.5 * beta_t, torch.sqrt(beta_t)


def unit_prior(shape: Sequence[int], T=1.0, generator: Optional[torch.Generator] = None,
               device=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N(0, I) whatever T: the VP and sub-VP priors."""
    return _normal(shape, generator, device, noise)


# ----- sub-VP (reference sde.py:49-63) -----

def subvp_marginal_prob(x, t, beta_0=0.1, beta_1=20.0):
    lmc = _log_mean_coeff(t, beta_0, beta_1)
    mean = None if x is None else torch.exp(lmc) * x
    return mean, 1.0 - torch.exp(2.0 * lmc)


def subvp_sde(t: torch.Tensor, beta_0=0.1, beta_1=20.0):
    beta_t = beta_0 + t * (beta_1 - beta_0)
    discount = 1.0 - torch.exp(-2.0 * beta_0 * t - (beta_1 - beta_0) * t ** 2)
    return -0.5 * beta_t, torch.sqrt(beta_t * discount)


# ----- EDM (reference sde.py:67-78): t is sigma -----

def edm_marginal_prob(x, t, sigma_min=0.002, sigma_max=80.0):
    return x, t


def edm_sde(t: torch.Tensor, sigma_min=0.002, sigma_max=80.0):
    return torch.zeros_like(t), torch.sqrt(2.0 * t)


def edm_prior(shape: Sequence[int], sigma_min=0.002, sigma_max=80.0, T=None,
              generator: Optional[torch.Generator] = None,
              device=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sigma * z with sigma = T (a truncated start draws at its start sigma)
    or sigma_max when T is None."""
    sigma = sigma_max if T is None else T
    return _normal(shape, generator, device, noise) * sigma


def init_sde(sde_mode: str) -> SDE:
    """Build an :class:`SDE` with the reference hyperparameters (JAX ``sde.py:121-157``)."""
    if sde_mode == "edm":
        kw = dict(sigma_min=0.002, sigma_max=80.0)
        return SDE(mode="edm", prior=functools.partial(edm_prior, **kw),
                   marginal_prob=functools.partial(edm_marginal_prob, **kw),
                   sde=functools.partial(edm_sde, **kw), eps=0.002, T=80.0)
    if sde_mode == "ve":
        kw = dict(sigma_min=0.01, sigma_max=50.0)
        return SDE(mode="ve", prior=functools.partial(ve_prior, **kw),
                   marginal_prob=functools.partial(ve_marginal_prob, **kw),
                   sde=functools.partial(ve_sde, **kw), eps=1e-5, T=1.0)
    if sde_mode == "vp":
        return SDE(mode="vp", prior=unit_prior, marginal_prob=vp_marginal_prob, sde=vp_sde,
                   eps=1e-3, T=1.0)
    if sde_mode == "subvp":
        return SDE(mode="subvp", prior=unit_prior, marginal_prob=subvp_marginal_prob,
                   sde=subvp_sde, eps=1e-3, T=1.0)
    raise NotImplementedError(f"sde mode {sde_mode} is not supported")
