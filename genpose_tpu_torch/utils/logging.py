"""Scalar logging (JSONL, and TensorBoard when installed), images (TensorBoard
only), the train clock, a text logger and the merge of inference results
(counterpart of ``genpose_tpu/utils/logging.py``).

Replaces the reference's tensorboardX plumbing (``posenet_agent.py:553-598``)
and ``TrainClock`` (``utils/genpose_utils.py:70-96``).  Every scalar lands in
``<log_dir>/metrics.jsonl``, so a run can be read without TensorBoard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def setup_logger(logger_name: str, log_file: str, level=None):
    """A ``logging`` logger writing ``asctime : message`` lines to
    ``log_file`` (appended) and to the stream (ref ``sgpa_utils.py:54-64``).
    A second setup of the same name replaces its handlers, so nothing is
    written twice."""
    import logging

    logger = logging.getLogger(logger_name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    formatter = logging.Formatter("%(asctime)s : %(message)s")
    fh = logging.FileHandler(log_file, mode="a")
    fh.setFormatter(formatter)
    logger.setLevel(level if level is not None else logging.INFO)
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    return logger


class TrainClock:
    """Epoch / minibatch / step counter (ref ``genpose_utils.py:70-96``)."""

    def __init__(self):
        self.epoch = 1
        self.minibatch = 0
        self.step = 0

    def tick(self):
        self.minibatch += 1
        self.step += 1

    def tock(self):
        self.epoch += 1
        self.minibatch = 0

    def make_checkpoint(self):
        return {"epoch": self.epoch, "minibatch": self.minibatch, "step": self.step}

    def restore_checkpoint(self, clock_dict):
        self.epoch = clock_dict["epoch"]
        self.minibatch = clock_dict["minibatch"]
        self.step = clock_dict["step"]

    @classmethod
    def restored(cls, clock_dict: Optional[dict]) -> "TrainClock":
        """A new clock at ``clock_dict`` (a ``clock.json``, as
        ``training/checkpoints.py::load_clock`` reads it), or at its start
        when there is none."""
        clock = cls()
        if clock_dict:
            clock.restore_checkpoint(clock_dict)
        return clock


class MetricsLogger:
    """Scalars to a JSONL file, and to TensorBoard if ``tensorboardX`` is installed."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.writer = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")
        # the file is read while a run goes on, and a crash must not lose its tail
        self._jsonl.flush()

    def scalars(self, values: Dict[str, float], step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", float(v), step)

    def image(self, tag: str, img, step: int):
        """An image [3, H, W] to TensorBoard when it is installed; nothing otherwise."""
        if self.writer is not None:
            self.writer.add_image(tag, img, step)

    def flush(self):
        self._jsonl.flush()
        if self.writer is not None:
            self.writer.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self.writer is not None:
            self.writer.close()


def merge_results(results_ori: dict, results_new: dict) -> dict:
    """Per-batch inference results concatenated along the first axis
    (``pred_pose``, ``gt_pose``, ``cls_id``, ``handle_visibility``; ref
    ``genpose_utils.py:99-110``); an empty ``results_ori`` gives
    ``results_new`` as it is."""
    import numpy as np

    if not results_ori:
        return results_new
    return {k: np.concatenate([np.asarray(results_ori[k]), np.asarray(results_new[k])], axis=0)
            for k in ("pred_pose", "gt_pose", "cls_id", "handle_visibility")}
