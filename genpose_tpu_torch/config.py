"""Configuration tree for genpose_tpu_torch (counterpart of ``genpose_tpu/config.py``).

The same ``Config`` dataclass fields, defaults and flag names as the JAX
package, so that one command line drives either package
(``tests/test_torch_isolation.py`` checks that both parsers accept the same
flags with the same defaults).  Defaults mirror the reference defaults and
the released training scripts (``scripts/train_score.sh``,
``scripts/train_energy.sh``, ``scripts/eval_single.sh``).

Fields that select JAX/TPU machinery are accepted for that parity and do
nothing in the port: ``device`` (entry points take their own ``device``
argument), ``num_devices``, ``gather_grad``, ``gather_fwd``,
``compile_cache_dir``.  The precision knobs ``compute_dtype`` (float32
or bfloat16), ``head_dtype``, ``bn_dtype``, ``geometry_dtype`` and
``encoder_f32_stages`` mean what they mean in the JAX package and are
validated the same way (``models/posenet.py`` applies them; ``bn_dtype``
changes nothing there, as in JAX).  The supported bfloat16 training mix is
``--compute_dtype bfloat16 --encoder_f32_stages -2``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class DynamicZoomInConfig:
    """DZI bbox jitter parameters (reference ``configs/config.py:90-95``)."""

    pad_scale: float = 1.5
    dzi_type: str = "uniform"
    scale_ratio: float = 0.25
    shift_ratio: float = 0.25


@dataclass(frozen=True)
class PtsAugConfig:
    """Batched 3D augmentation probabilities (reference ``configs/config.py:97-104``)."""

    aug_pc_pro: float = 0.2   # per-point jitter probability
    aug_pc_r: float = 0.2     # per-point jitter range
    aug_rt_pro: float = 0.3   # random rotation/translation probability
    aug_bb_pro: float = 0.3   # bbox-based anisotropic scaling probability
    aug_bc_pro: float = 0.3   # bowl/mug box-cage deformation probability


@dataclass(frozen=True)
class Deform2DConfig:
    """2D mask deformation parameters (reference ``configs/config.py:106-110``)."""

    roi_mask_r: int = 3
    roi_mask_pro: float = 0.5


@dataclass
class Config:
    """Full configuration (reference ``configs/config.py:4-112``)."""

    # ---- dataset ----
    synset_names: Tuple[str, ...] = ("bottle", "bowl", "camera", "can", "laptop", "mug")
    selected_classes: Optional[Tuple[str, ...]] = None
    data_path: str = ""
    o2c_pose: bool = True
    batch_size: int = 192
    max_batch_size: int = 192
    mini_bs: int = 192
    pose_mode: str = "rot_matrix"
    seed: int = 0
    percentage_data_for_train: float = 1.0
    percentage_data_for_val: float = 1.0
    percentage_data_for_test: float = 1.0
    train_source: str = "CAMERA+Real"
    val_source: str = "CAMERA"
    test_source: str = "Real"
    device: str = "tpu"
    num_points: int = 1024
    per_obj: str = ""
    num_workers: int = 8
    loader_mode: str = "thread"

    # ---- model ----
    posenet_mode: str = "score"
    hidden_dim: int = 128
    sampler_mode: Tuple[str, ...] = ("ode",)
    sampling_steps: int = 500
    sde_mode: str = "ve"
    sigma: float = 25.0
    likelihood_weighting: bool = False
    regression_head: str = "Rx_Ry_and_T"
    pointnet2_params: str = "light"
    pts_encoder: str = "pointnet2"
    energy_mode: str = "IP"
    s_theta_mode: str = "score"
    norm_energy: str = "identical"

    # ---- training ----
    agent_type: str = "score"  # one of [score, energy, energy_with_ranking]
    pretrained_score_model_path: Optional[str] = None
    pretrained_energy_model_path: Optional[str] = None
    distillation: bool = False
    n_epochs: int = 1000
    log_dir: str = "debug"
    optimizer: str = "Adam"
    eval_freq: int = 100
    repeat_num: int = 20
    grad_clip: float = 1.0
    ema_rate: float = 0.999
    lr: float = 1e-3
    warmup: int = 100
    lr_decay: float = 0.98
    lr_floor: float = 1e-4
    use_pretrain: bool = False
    num_devices: int = 0
    is_train: bool = False

    # ---- precision / performance ----
    compute_dtype: str = "float32"  # or "bfloat16"; params stay float32
    head_dtype: str = "compute"
    gather_grad: str = "fast"
    gather_fwd: str = "fast"
    bn_dtype: str = "compute"
    geometry_dtype: str = "compute"
    encoder_f32_stages: int = 0
    compile_cache_dir: str = "/tmp/genpose_jax_cache"

    # ---- testing ----
    eval: bool = False
    pred: bool = False
    likelihood: bool = False
    model_name: Optional[str] = None
    eval_repeat_num: int = 50
    save_video: bool = False
    max_eval_num: int = 10_000_000
    results_path: str = ""
    T0: float = 1.0

    # ---- nocs mrcnn testing ----
    img_size: int = 256
    result_dir: str = ""
    model_dir_list: Optional[Tuple[str, ...]] = None
    energy_model_dir: str = ""
    score_model_dir: str = ""
    ranker: str = "energy_ranker"  # energy_ranker, gt_ranker or random
    pooling_mode: str = "nearest"  # nearest or average
    # top-ratio hypothesis selection before pooling (ref hardcodes 0.6 at
    # ``evaluation_single.py:534``)
    ratio: float = 0.6
    eval_ratios: Tuple[float, ...] = (0.6,)

    # ---- nested parameter groups ----
    dzi: DynamicZoomInConfig = field(default_factory=DynamicZoomInConfig)
    pts_aug: PtsAugConfig = field(default_factory=PtsAugConfig)
    deform_2d: Deform2DConfig = field(default_factory=Deform2DConfig)

    def __post_init__(self):
        # fail fast on knob typos (ValueError, not assert: survives python -O)
        for name, allowed in (("compute_dtype", ("float32", "bfloat16")),
                              ("head_dtype", ("compute", "float32")),
                              ("loader_mode", ("thread", "process")),
                              ("gather_grad", ("exact", "fast")),
                              ("gather_fwd", ("exact", "fast")),
                              ("bn_dtype", ("compute", "float32")),
                              ("geometry_dtype", ("compute", "float32"))):
            val = getattr(self, name)
            if val not in allowed:
                raise ValueError(f"{name}={val!r} not in {allowed}")
        if not -5 <= self.encoder_f32_stages <= 5:
            raise ValueError(
                f"encoder_f32_stages={self.encoder_f32_stages} not in [-5, 5]")

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


_NESTED = ("dzi", "pts_aug", "deform_2d")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.name in _NESTED:
            continue
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        ftype = f.type if isinstance(f.type, str) else str(f.type)
        if f.type in ("bool", bool):
            # both the bare store_true form and the explicit true/false form
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                nargs="?", const=True, default=default)
        elif "Tuple" in ftype or isinstance(default, tuple):
            if isinstance(default, tuple) and default:
                elem = type(default[0])
            elif "float" in ftype:
                elem = float
            elif "int" in ftype:
                elem = int
            else:
                elem = str
            parser.add_argument(name, nargs="+", type=elem, default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def get_config(argv: Optional[List[str]] = None) -> Config:
    """Build a Config, optionally overridden from CLI-style arguments.

    Never parses ``sys.argv`` implicitly; pass ``argv`` explicitly.  Unknown
    flags are an error.  ``--parallel``/``--num_gpu`` (the reference's GPU
    knobs) are accepted and ignored, as in the JAX package.
    """
    parser = argparse.ArgumentParser(description="genpose_tpu_torch")
    _add_dataclass_args(parser, Config)
    parser.add_argument("--parallel", nargs="?", const="1", default=None,
                        help="ignored (reference compatibility)")
    parser.add_argument("--num_gpu", type=int, default=None,
                        help="ignored (reference compatibility)")
    ns = parser.parse_args(argv if argv is not None else [])
    overrides = {}
    for f in dataclasses.fields(Config):
        if f.name in _NESTED:
            continue
        v = getattr(ns, f.name, None)
        if v is not None:
            overrides[f.name] = tuple(v) if isinstance(v, list) else v
    return Config(**overrides)
