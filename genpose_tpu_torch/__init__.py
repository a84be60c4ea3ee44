"""genpose_tpu_torch: the PyTorch/CUDA port of ``genpose_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package (``genpose_tpu_torch/ops/pose.py`` is the
counterpart of ``genpose_tpu/ops/pose.py``, and so on).  Plain tensor code is
PyTorch; the point-cloud kernels (furthest point sampling, ball query and
the fused FPS + ball query) are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built on first use by ``ops/_build.py``.

This package imports ``torch``, numpy and the standard library only (and
matplotlib, when it is installed, to draw the mAP curve).  Entry points
(``InferencePipeline``, ``PoseAgent``, ``build_model``, the trainer and the
evaluation and tracking runners) run on
``device="cuda"`` unless the caller passes ``device="cpu"``, and raise when
CUDA is asked for but absent.

TF32 is switched off here, at import: the JAX package is the float32
reference, and cuBLAS/cuDNN in TF32 keep only ~3 decimal digits.  The
SharedMLPs are ``F.linear`` over channels-last tensors (no ``Conv2d``), so
cuDNN is not on the path either way.  bfloat16 GEMMs (``compute_dtype``)
must accumulate in float32, as XLA's do: PyTorch lets cuBLAS reduce them in
bfloat16 (split-K partial sums) unless
``allow_bf16_reduced_precision_reduction`` is off, which it is from here on.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
