"""Wrapper of the fused score-head kernel (``csrc/score_head.cu``).

One score evaluation of ``models/scorenet.py::PoseScoreNet`` over a float32
``FusedTails`` bank at a step-shared time t [1, 1]: the pose MLP, the tails
and the division by sigma(t) + 1e-7, in two launches (the t row and the
transposed pose-MLP weights, then the head) where the plain PyTorch
arithmetic takes ~30.  It replaces no TPU
kernel: the JAX package leaves the head to XLA.  The plain version is
``score_head_ref`` (``score_from``'s own arithmetic); ``score_from`` calls
this wrapper when its inputs show the fused path applies, and the plain
arithmetic otherwise (``models/scorenet.py::fused_head_applies``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from genpose_tpu_torch.ops import _build

WIDTH, T_DIM, CHUNK = 256, 128, 256  # pose MLP width, t embedding, tail columns a chunk
MAX_POSE, MAX_OUT = 16, 16  # csrc/score_head.cu's kMaxPose, kMaxOut
SCRATCH = 16 * WIDTH + WIDTH * WIDTH  # W0^T padded and W1^T; the t row follows

# Kernel launches (head evaluations) since import.  A run that resets it and
# reads it afterwards shows whether a path went through the kernel.
launches = 0


def score_head_ref(trunk, fp: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                   std: torch.Tensor) -> torch.Tensor:
    """The plain arithmetic: the trunk's head over sigma(t) + 1e-7."""
    return trunk.f_theta_from(fp, x, t) / (std + 1e-7)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(n: int, num_sms: int, tail_cols: int = 768,
                 outs: int = 3) -> Tuple[int, int, int, int]:
    """(consumer warps, rows a block, blocks, dynamic shared bytes) of the
    head kernel for n rows on ``num_sms`` SMs, ``tail_cols`` = T * H tail
    columns and ``outs`` = O outputs a tail."""
    shape = (ctypes.c_int * 4)()
    _build.check(_build.library().gp_score_head_shape(n, num_sms, tail_cols, outs, shape),
                 "score head shape")
    return tuple(shape)


def _operand(name: str, v: torch.Tensor, shape, device, vectors: bool = False) -> torch.Tensor:
    """``v`` as the kernel reads it; ``vectors``: read 16 bytes at a time."""
    if v.device != device or v.dtype != torch.float32 or tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name} must be float32 {tuple(shape)} on {device}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if not v.is_contiguous() or (vectors and v.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous" + (" and 16-byte aligned" if vectors else ""))
    return v


def score_head(trunk, fp: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
               std: torch.Tensor) -> torch.Tensor:
    """x [n, D] poses, fp [n, T*H] the tails' pts_feat projection, t and std
    [1, 1], all float32 on one CUDA device; ``trunk`` a ``PoseTrunk`` over a
    float32 ``FusedTails`` bank -> the score [n, T*O]."""
    global launches
    if not x.is_cuda:
        raise ValueError("score_head takes CUDA tensors")
    dev = x.device
    n, D = x.shape if x.dim() == 2 else (0, 0)
    tails = trunk.tails
    T, H, O = tails.num_tails, tails.hidden, tails.out_dim
    NT = T * H
    if n < 1 or not 1 <= D <= MAX_POSE or H % CHUNK or T * O > MAX_OUT:
        raise ValueError(f"score_head takes x [n>=1, D<={MAX_POSE}], hidden a multiple of "
                         f"{CHUNK} and at most {MAX_OUT} outputs; got x {tuple(x.shape)}, "
                         f"{T} tails of {H} -> {O}")
    args = [
        _operand("x", x, (n, D), dev),
        _operand("t", t, (1, 1), dev),
        _operand("std", std, (1, 1), dev),
        _operand("t_fourier.W", trunk.t_fourier.W, (T_DIM // 2,), dev),
        _operand("t_dense.weight", trunk.t_dense.weight, (T_DIM, T_DIM), dev),
        _operand("t_dense.bias", trunk.t_dense.bias, (T_DIM,), dev),
        _operand("pose_dense_0.weight", trunk.pose_dense_0.weight, (WIDTH, D), dev),
        _operand("pose_dense_0.bias", trunk.pose_dense_0.bias, (WIDTH,), dev),
        _operand("pose_dense_1.weight", trunk.pose_dense_1.weight, (WIDTH, WIDTH), dev),
        _operand("pose_dense_1.bias", trunk.pose_dense_1.bias, (WIDTH,), dev),
        _operand("fp", fp, (n, NT), dev, vectors=True),
        _operand("t_kernel", tails.t_kernel, (T_DIM, NT), dev),
        _operand("pose_kernel", tails.pose_kernel, (WIDTH, NT), dev, vectors=True),
        _operand("bias", tails.bias, (NT,), dev, vectors=True),
        _operand("out_kernel", tails.out_kernel, (T, H, O), dev, vectors=True),
        _operand("out_bias", tails.out_bias, (T, O), dev),
    ]
    scratch = torch.empty((SCRATCH + NT,), dtype=torch.float32, device=dev)
    out = torch.empty((n, T * O), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.gp_score_head(*(a.data_ptr() for a in args), scratch.data_ptr(),
                                   out.data_ptr(), n, D, T, H, O, _num_sms(dev.index), stream)
        launches += 1
    _build.check(status, "score head kernel launch")
    return out
