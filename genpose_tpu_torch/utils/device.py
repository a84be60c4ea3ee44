"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for but absent.

    Entry points default to ``"cuda"``.  There is no silent fallback to the
    CPU: a caller that wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def runner_device(cfg) -> torch.device:
    """The device a runner's ``main`` uses: ``cfg.device`` when it names the
    CPU or a card, else the card (the config's default ``tpu`` included)."""
    name = cfg.device
    return resolve_device(name if name == "cpu" or name.startswith("cuda") else "cuda")
