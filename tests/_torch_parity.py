"""Shared set-up for the genpose_tpu_torch parity tests.

JAX agents get non-zero heads (``derandomize_state``), an EMA shadow that
differs from the live params, and non-trivial BatchNorm running statistics,
so that a port that loads the wrong set of weights, or maps one wrongly,
disagrees.  Inputs are numpy arrays handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from genpose_tpu.training.agent import PoseAgent as JaxAgent
from genpose_tpu.utils.benchmarking import derandomize_state
from genpose_tpu_torch.training.agent import PoseAgent as TorchAgent


def _perturb_stats(batch_stats, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(batch_stats)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(batch_stats)[0]]
    out = []
    for path, leaf in zip(paths, leaves):
        leaf = np.asarray(leaf)
        if "mean" in path:
            leaf = leaf + 0.1 * rng.normal(size=leaf.shape)
        else:
            leaf = leaf * rng.uniform(0.5, 1.5, size=leaf.shape)
        out.append(jnp.asarray(leaf, jnp.float32))
    return jax.tree.unflatten(treedef, out)


def derandomize_agent(agent, seed):
    """Distinct live params and EMA shadow, both non-zero in the heads."""
    st = derandomize_state(agent.state, seed=seed)
    shadow = derandomize_state(st, seed=seed + 100).params
    agent.state = st.replace(ema=st.ema.replace(shadow=shadow),
                             batch_stats=_perturb_stats(st.batch_stats, seed))
    return agent


def jax_agent(cfg, mode, seed, **kwargs):
    return derandomize_agent(JaxAgent(cfg, mode, **kwargs), seed)


def train_agent(cfg, mode, seed, **kwargs):
    """A derandomised JAX agent whose state could come from training: the
    EMA shadow's Fourier ``W`` equals the params' (``W`` is never updated,
    so a real shadow never moves it; ``derandomize_agent`` perturbs it)."""
    agent = jax_agent(cfg, mode, seed, **kwargs)
    st = agent.state
    shadow = jax.tree_util.tree_map(lambda x: x, st.ema.shadow)
    shadow["head"]["trunk"]["t_fourier"]["W"] = jnp.copy(
        st.params["head"]["trunk"]["t_fourier"]["W"])
    agent.state = st.replace(ema=st.ema.replace(shadow=shadow))
    return agent


def port_agent(cfg, mode, agent, use_ema):
    """The port's agent on the CPU holding ``agent``'s EMA shadow or live params."""
    st = agent.state
    params = st.ema.shadow if use_ema else st.params
    return TorchAgent(cfg, mode, device="cpu").load_jax(
        jax.device_get(params), jax.device_get(st.batch_stats))


def pin_jax_prior(agent, noise):
    """The JAX SDE's prior returns the first rows of ``noise`` as they are."""
    agent.sde = dataclasses.replace(
        agent.sde, prior=lambda key, shape, T=None: jnp.asarray(noise[:shape[0]]))


def pin_port_prior(agent, noise):
    """The port's SDE's prior returns the first rows of ``noise`` as they are."""
    agent.sde = dataclasses.replace(
        agent.sde,
        prior=lambda shape, T=None, generator=None, device=None: torch.from_numpy(
            np.ascontiguousarray(noise[:shape[0]])).to(device))


def dsm_noise(key, sde_eps, repeat, bs, pose_dim=9):
    """The draws the JAX ``dsm_loss_repeated`` makes from ``key``, as the
    port's ``noise`` argument: (t [repeat, bs, 1], z [repeat, bs, pose_dim])."""
    ts, zs = [], []
    for k in jax.random.split(key, repeat):
        k_t, k_z = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(k_t, (bs, 1), minval=sde_eps, maxval=1.0)))
        zs.append(np.asarray(jax.random.normal(k_z, (bs, pose_dim))))
    return torch.from_numpy(np.stack(ts)), torch.from_numpy(np.stack(zs))


def t_np(x):
    return torch.from_numpy(np.array(x, order="C", copy=True))
