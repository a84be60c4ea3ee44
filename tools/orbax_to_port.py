#!/usr/bin/env python
"""Convert a genpose_tpu (JAX) orbax checkpoint into a genpose_tpu_torch checkpoint.

The JAX package saves ``<dir>/ckpt_epoch{N}`` with orbax (an OCDBT tree that
only tensorstore reads) beside a ``clock.json``.  This tool restores it into
a ``PoseAgent(cfg, posenet_mode).state`` template, carries the whole
training state across with
``genpose_tpu_torch/utils/weights.py::from_jax_train_state`` (params,
BatchNorm statistics, EMA shadow and count, optimizer moments, step) and
writes the port's format with ``genpose_tpu_torch``'s ``save_checkpoint``:
``<output>/ckpt_epoch{N}`` + ``clock.json``.  The port then serves it
(``InferencePipeline(score_ckpt=..., energy_ckpt=...)``), evaluates it or
resumes training from it, with no JAX.

It runs where JAX runs (on the CPU backend).  The configuration flags are
those of ``genpose_tpu/config.py`` and must describe the model and
optimizer that wrote the checkpoint (``--posenet_mode``, ``--sde_mode``,
``--optimizer``, ``--regression_head``...).

Usage:
    python tools/orbax_to_port.py \\
        --input  results/ckpts/ScoreNet/ckpt_epoch1900 \\
        --output results/ckpts/ScoreNet_port \\
        [--epoch N] [config flags, e.g. --posenet_mode score --sde_mode ve]
"""

import argparse
import os
import re
import sys


def main(argv=None):
    # force the CPU backend before anything touches jax: conversion is host work
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception as e:
        print(f"WARNING: could not force the CPU backend ({e}); "
              "converting on the default backend", file=sys.stderr)

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="orbax ckpt_epochN directory to read")
    p.add_argument("--output", required=True, help="checkpoint directory to write")
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch tag for the output (default: the input's ckpt_epochN)")
    args, rest = p.parse_known_args(argv)

    from genpose_tpu.config import get_config as jax_config
    from genpose_tpu.training.agent import PoseAgent as JaxAgent
    from genpose_tpu.training.checkpoints import load_checkpoint, load_clock
    from genpose_tpu_torch.config import get_config as torch_config
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import save_checkpoint
    from genpose_tpu_torch.utils.weights import from_jax_train_state

    jcfg, tcfg = jax_config(rest), torch_config(rest)
    src = os.path.abspath(args.input)
    state = load_checkpoint(src, JaxAgent(jcfg, jcfg.posenet_mode).state)
    agent = PoseAgent(tcfg, tcfg.posenet_mode, device="cpu")
    from_jax_train_state(jax.device_get(state), agent)
    epoch = args.epoch
    if epoch is None:
        m = re.fullmatch(r"ckpt_epoch(\d+)", os.path.basename(src))
        epoch = int(m.group(1)) if m else 0
    path = save_checkpoint(args.output, agent, epoch, clock=load_clock(os.path.dirname(src)))
    print(f"converted {args.input} -> {path}")
    return path


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
