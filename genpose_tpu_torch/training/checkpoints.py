"""Checkpoint save and restore (counterpart of ``genpose_tpu/training/checkpoints.py:45-108``).

The port's own format, one ``torch.save`` file per checkpoint: the model's
``state_dict`` (live parameters and BatchNorm running statistics), the step,
the optimizer moments and the EMA shadow and count.  The layout follows the
reference: ``<dir>/ckpt_epoch{N}`` beside a ``clock.json``.  Unlike the
reference (``posenet_agent.py:117-141``) the EMA shadow is saved.  The JAX
package's orbax checkpoints are converted to this format where JAX runs
(``tools/orbax_to_port.py``), released ``.pth`` files by
``genpose_tpu_torch/tools/port_torch_ckpt.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from genpose_tpu_torch.training.state import EMA


def save_checkpoint(ckpt_dir: str, agent, epoch: int, clock: Optional[dict] = None) -> str:
    """Write ``ckpt_epoch{epoch}`` (and ``clock.json``) under ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt_epoch{epoch}"))
    st = agent.state
    tmp = path + ".tmp"
    torch.save({
        "model": agent.model.state_dict(),
        "step": st.step,
        "optimizer": st.optimizer,
        "opt_state": st.opt_state,
        "ema_num_updates": st.ema.num_updates,
        "ema_shadow": st.ema.shadow,
    }, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    if clock is not None:
        with open(os.path.join(ckpt_dir, "clock.json"), "w") as f:
            json.dump(clock, f)
    return path


def load_checkpoint(path: str, agent, load_model_only: bool = False) -> None:
    """Restore ``agent`` from ``path`` (ref ``load_ckpt``).  ``load_model_only``
    restores the weights, BatchNorm statistics and EMA but keeps the agent's
    step and optimizer state (eval, fine-tuning; ``posenet_agent.py:170-173``)."""
    ckpt = torch.load(path, map_location=agent.device, weights_only=True)
    agent.model.load_state_dict(ckpt["model"])
    st = agent.state
    st.ema = EMA(st.ema.decay, ckpt["ema_shadow"], ckpt["ema_num_updates"])
    if not load_model_only:
        if ckpt["optimizer"] != st.optimizer:
            raise ValueError(f"checkpoint was trained with {ckpt['optimizer']}, "
                             f"the agent uses {st.optimizer}")
        st.step = ckpt["step"]
        st.opt_state = ckpt["opt_state"]


def load_clock(ckpt_dir: str) -> Optional[dict]:
    p = os.path.join(ckpt_dir, "clock.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-epoch ``ckpt_epoch{N}`` in ckpt_dir."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_n = None, -1
    for name in os.listdir(ckpt_dir):
        if name.startswith("ckpt_epoch"):
            try:
                n = int(name[len("ckpt_epoch"):])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(ckpt_dir, name), n
    return best
