"""Weights for the port: conversion from the JAX package, seeded init, perturbation.

``from_jax_variables`` takes the JAX package's parameters as nested dicts of
arrays (what ``jax.device_get(agent.state.params)`` or ``...ema.shadow``
returns) plus its ``batch_stats``, and returns the port's ``state_dict``.
The port's module and parameter names follow the flax tree, so the mapping
is by name:

- flax ``Dense`` ``kernel [in, out]`` -> ``nn.Linear.weight [out, in]``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``; ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
- everything else (``FusedTails``' raw kernels, the Fourier ``W``) is copied
  as it is.

Which JAX weights to convert is the caller's choice and matters: the JAX
serving pipeline samples with the score agent's EMA shadow
(``agent.py:477``) and ranks with the energy agent's live params
(``agent.py:583``).  ``from_jax_train_state`` carries a whole JAX training
state (params, BatchNorm statistics, EMA shadow, step, optimizer moments)
into a port agent.  ``to_jax_variables`` goes the other way: a port model's
weights in the flax layout (the template that ``utils/torch_port.py``
checks an upstream checkpoint against).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C", copy=True))


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``params`` + ``batch_stats`` (nested dicts of arrays) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        *mods, name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense kernel, got {arr.shape}")
            name, arr = "weight", arr.T
        elif name == "scale":
            name = "weight"
        sd[".".join([*mods, name])] = _tensor(arr)
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _leaves(batch_stats):
        *mods, name = path
        sd[".".join([*mods, stat_names[name]])] = _tensor(leaf)
        sd[".".join([*mods, "num_batches_tracked"])] = torch.tensor(0, dtype=torch.long)
    return sd


def to_jax_variables(model: nn.Module) -> Tuple[Dict, Dict]:
    """A port model's weights as the JAX package's (params, batch_stats):
    nested dicts of float32 numpy arrays under the flax names, the inverse
    of ``from_jax_variables`` (``num_batches_tracked`` has no flax
    counterpart and is left out)."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, name: str, leaf: str, value: torch.Tensor) -> None:
        node = tree
        for part in name.split(".") if name else ():
            node = node.setdefault(part, {})
        node[leaf] = value.detach().float().cpu().numpy().copy()

    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            put(params, name, "kernel", m.weight.t())
            if m.bias is not None:
                put(params, name, "bias", m.bias)
        elif isinstance(m, nn.BatchNorm1d):
            put(params, name, "scale", m.weight)
            put(params, name, "bias", m.bias)
            put(stats, name, "mean", m.running_mean)
            put(stats, name, "var", m.running_var)
        else:
            for leaf, t in [*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)]:
                put(params, name, leaf, t)
    return params, stats


def shadow_from_jax(ema_shadow: Mapping, params: Mapping, names, device) -> Dict[str, torch.Tensor]:
    """A JAX EMA shadow as the port's shadow: a tensor per parameter name in
    ``names``.  The port keeps the Fourier ``W`` as a buffer outside the
    shadow, so the JAX shadow's ``W`` must equal the params' (it does in any
    JAX state: ``W`` gets no update, so its average never moves)."""
    sd, live = from_jax_variables(ema_shadow, {}), from_jax_variables(params, {})
    for k in sd.keys() - set(names):
        if not torch.equal(sd[k], live[k]):
            raise ValueError(f"the EMA shadow's {k} differs from the params': the port "
                             f"keeps it as a buffer, outside the shadow")
    return {k: sd[k].to(device) for k in names}


def _find_opt_states(node) -> Iterator[object]:
    """The optax states inside a nested optimizer state that carry moments
    (``mu``/``nu`` of Adam, ``trace`` of SGD momentum).  optax states are
    named tuples, read by field name, so no optax import is needed."""
    fields = getattr(node, "_fields", ())
    if {"mu", "nu"} <= set(fields) or "trace" in fields:
        yield node
    elif isinstance(node, (tuple, list)):
        for child in node:
            yield from _find_opt_states(child)


def from_jax_train_state(jax_state, agent) -> None:
    """Carry a JAX package ``TrainState`` into a port ``PoseAgent``, so
    that training resumes where the JAX state stands.

    ``jax_state`` has the JAX TrainState's fields (``step``, ``params``,
    ``batch_stats``, ``opt_state``, ``ema.num_updates``, ``ema.shadow``) as
    arrays or nested dicts of arrays.  Loaded: params and BatchNorm running
    statistics into ``agent.model``; step, EMA shadow and count, and Adam's
    ``mu``/``nu`` (or SGD's ``trace``) into ``agent.state``.  The agent's
    optimizer must be the one that made the state.
    """
    from genpose_tpu_torch.training.state import EMA

    agent.model.load_state_dict(from_jax_variables(jax_state.params, jax_state.batch_stats))
    names = set(agent.params())

    def params_only(tree) -> Dict[str, torch.Tensor]:
        sd = from_jax_variables(tree, {})
        return {k: v.to(agent.device) for k, v in sd.items() if k in names}

    st = agent.state
    st.step = int(np.asarray(jax_state.step))
    st.ema = EMA(st.ema.decay,
                 shadow_from_jax(jax_state.ema.shadow, jax_state.params, names, agent.device),
                 int(np.asarray(jax_state.ema.num_updates)))
    found = list(_find_opt_states(jax_state.opt_state))
    if len(found) != 1:
        raise ValueError(f"expected one optimizer state with moments, found {len(found)}")
    opt = found[0]
    if hasattr(opt, "mu"):
        if st.optimizer != "Adam":
            raise ValueError(f"an Adam state cannot resume a {st.optimizer} agent")
        st.opt_state = {"mu": params_only(opt.mu), "nu": params_only(opt.nu)}
    else:
        if st.optimizer != "SGD":
            raise ValueError(f"an SGD state cannot resume a {st.optimizer} agent")
        st.opt_state = {"trace": params_only(opt.trace)}


@torch.no_grad()
def init_params_(model: nn.Module, seed: int) -> nn.Module:
    """Fresh weights with the JAX package's initialiser families, drawn from a
    CPU generator seeded with ``seed`` (so the same seed gives the same
    weights on every device):

    - Linear: normal, std 1/sqrt(fan_in) (lecun), zero bias;
    - BatchNorm: weight 1, bias 0, running mean 0, running var 1;
    - Fourier ``W``: normal x scale;
    - tail first layers (``PerPointTail``'s conv1 too): normal, std
      1/sqrt(concatenated fan-in);
    - fusion tail outputs: zero, as the reference zero-initialises them;
    - a PointNet spatial transformer's last layer: zero (the identity);
    - the frozen image tower's buffers: ``ImageTower.reset_``.
    """
    from genpose_tpu_torch.models.layers import (
        FusedTails,
        GaussianFourierProjection,
        PerPointTail,
        SplitTail,
    )
    from genpose_tpu_torch.models.pointnet import STNkd
    from genpose_tpu_torch.models.vit import ImageTower

    g = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
        elif isinstance(m, GaussianFourierProjection):
            normal_(m.W, m.scale)
        elif isinstance(m, FusedTails):
            fan_in = m.feat_kernel.shape[0] + m.t_kernel.shape[0] + m.pose_kernel.shape[0]
            for k in (m.feat_kernel, m.t_kernel, m.pose_kernel):
                normal_(k, 1.0 / math.sqrt(fan_in))
            for z in (m.bias, m.out_kernel, m.out_bias):
                z.zero_()
        elif isinstance(m, PerPointTail):
            fan_in = m.feat_kernel.shape[0] + m.t_kernel.shape[0] + m.pose_kernel.shape[0]
            for k in (m.feat_kernel, m.t_kernel, m.pose_kernel):
                normal_(k, 1.0 / math.sqrt(fan_in))
            m.bias1.zero_()
        elif isinstance(m, ImageTower):
            m.reset_(g)
    # after the Linear pass above, so the zeros stick
    for m in model.modules():
        if isinstance(m, SplitTail):
            fan_in = m.feat.in_features + m.dyn.in_features
            normal_(m.feat.weight, 1.0 / math.sqrt(fan_in))
            normal_(m.dyn.weight, 1.0 / math.sqrt(fan_in))
            m.out.weight.zero_()
            m.out.bias.zero_()
        elif isinstance(m, STNkd):
            m.Dense_5.weight.zero_()
            m.Dense_5.bias.zero_()
    return model


@torch.no_grad()
def perturb_(model: nn.Module, seed: int, scale: float = 0.01) -> nn.Module:
    """Add ``scale * N(0, 1)`` to every parameter (not the buffers), drawn from a
    CPU generator seeded with ``seed``: makes the zero-initialised heads do
    real work for tests and timing runs, as the JAX package's
    ``derandomize_state`` does."""
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.add_(torch.randn(p.shape, generator=g).to(p.device) * scale)
    return model
