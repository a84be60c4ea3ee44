"""genpose_tpu_torch stands alone: no JAX imports, the same flags, no silent CPU.

A runtime ``sys.modules`` check cannot show the first point, because this
image imports jax at interpreter start; the imports are read from the
source instead.
"""

import argparse
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from genpose_tpu import config as jax_config
from genpose_tpu_torch import config as torch_config

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "genpose_tpu"}
PORT_FILES = sorted((ROOT / "genpose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "genpose_tpu_torch/runners/serving.py",
                 "genpose_tpu_torch/ops/fps_cuda.py", "genpose_tpu_torch/ops/ball_query_cuda.py",
                 "genpose_tpu_torch/ops/fps_bq_fused_cuda.py",
                 "genpose_tpu_torch/tools/bench_fused_geometry.py",
                 "genpose_tpu_torch/runners/evaluation_single.py",
                 "genpose_tpu_torch/runners/evaluation_tracking.py",
                 "genpose_tpu_torch/eval/nocs_eval.py", "genpose_tpu_torch/data/dataset_utils.py",
                 "genpose_tpu_torch/utils/png.py", "genpose_tpu_torch/utils/tracking.py",
                 "genpose_tpu_torch/utils/torch_port.py",
                 "genpose_tpu_torch/tools/port_torch_ckpt.py",
                 "genpose_tpu_torch/data/nocs.py", "genpose_tpu_torch/data/loader.py",
                 "genpose_tpu_torch/runners/trainer.py", "genpose_tpu_torch/parallel/group.py",
                 "genpose_tpu_torch/tools/dryrun_multi.py",
                 "genpose_tpu_torch/utils/benchmarking.py", "genpose_tpu_torch/eval/draw.py",
                 "genpose_tpu_torch/native/__init__.py"):
        assert must in names


def _module_level_imports(path):
    """Roots imported outside any function body."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nested = {id(n) for f in ast.walk(tree)
              if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
              for n in ast.walk(f)}
    for node in ast.walk(tree):
        if id(node) in nested:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_needs_no_image_library(path):
    """The card's machine has no OpenCV, PIL or matplotlib: the port never
    imports the first two and imports matplotlib only inside the function
    that draws a curve (``eval/nocs_eval.py::plot_mAP``)."""
    assert not {"cv2", "PIL"} & set(_imported_roots(path))
    assert "matplotlib" not in set(_module_level_imports(path))


def _flags(module):
    parser = argparse.ArgumentParser()
    module._add_dataclass_args(parser, module.Config)
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_both_parsers_accept_the_same_flags_with_the_same_defaults():
    assert _flags(torch_config) == _flags(jax_config)
    jfields = {f.name: f.default for f in dataclasses.fields(jax_config.Config)}
    tfields = {f.name: f.default for f in dataclasses.fields(torch_config.Config)}
    assert tfields == jfields
    assert dataclasses.asdict(torch_config.get_config([])) == dataclasses.asdict(
        jax_config.get_config([]))


@pytest.mark.parametrize("argv", [
    ["--num_points", "256", "--eval_repeat_num", "7", "--T0", "0.15"],
    ["--sampler_mode", "ode_adaptive", "--is_train", "--o2c_pose", "false"],
    ["--selected_classes", "mug", "bowl", "--eval_ratios", "0.4", "0.6"],
    ["--parallel", "--num_gpu", "2", "--ratio", "0.5"],
    ["--compute_dtype", "bfloat16", "--head_dtype", "float32", "--bn_dtype", "float32",
     "--geometry_dtype", "float32", "--encoder_f32_stages", "-2"],
    ["--compute_dtype", "bfloat16", "--encoder_f32_stages", "2"],
])
def test_both_parsers_read_the_same_values(argv):
    assert dataclasses.asdict(torch_config.get_config(argv)) == dataclasses.asdict(
        jax_config.get_config(argv))


def test_unknown_flag_is_an_error():
    with pytest.raises(SystemExit):
        torch_config.get_config(["--num_pointz", "3"])


def test_entry_points_raise_without_cuda(monkeypatch):
    from genpose_tpu_torch.models.posenet import build_model
    from genpose_tpu_torch.parallel import make_group
    from genpose_tpu_torch.runners import evaluation_single, trainer
    from genpose_tpu_torch.runners.serving import InferencePipeline
    from genpose_tpu_torch.tools.dryrun_multi import dryrun_multidevice
    from genpose_tpu_torch.training.agent import PoseAgent

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config.Config(num_points=32)
    for make in (lambda: InferencePipeline(cfg), lambda: PoseAgent(cfg),
                 lambda: build_model(cfg), lambda: PoseAgent(cfg, device="cuda:0"),
                 lambda: trainer.main(["--agent_type", "score", "--data_path", "unread"]),
                 lambda: trainer.main(["--results_path", "unread.pkl", "--device", "cuda"]),
                 lambda: trainer.evaluation(torch_config.Config(results_path="unread.pkl")),
                 # several devices: the trainer's and the evaluation's spawn paths,
                 # the dry run and the group itself
                 lambda: trainer.main(["--agent_type", "score", "--data_path", "unread",
                                       "--num_devices", "2"]),
                 lambda: trainer.main(["--agent_type", "score", "--data_path", "unread",
                                       "--num_devices", "0"]),
                 lambda: evaluation_single.main(["--data_path", "unread", "--num_devices", "2"]),
                 lambda: dryrun_multidevice(2), lambda: make_group()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    model = build_model(cfg, "score", device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_unported_configurations_raise():
    """Every encoder, stage config and pose mode of the JAX config is ported
    (``test_every_config_value_builds``); a value neither package has still
    raises, as does ``Rx_Ry_and_T`` over a pose mode other than
    ``rot_matrix`` (as in JAX)."""
    from genpose_tpu_torch.models.posenet import build_model

    Config = torch_config.Config
    for cfg in (Config(pointnet2_params="huge"), Config(pts_encoder="pointnet3"),
                Config(pose_mode="euler_zyz", regression_head="RT"),
                Config(regression_head="R_then_T"), Config(pose_mode="euler_xyz")):
        with pytest.raises((NotImplementedError, KeyError)):
            build_model(cfg, "score", device="cpu")


@pytest.mark.parametrize("flag,value", [
    *[("pts_encoder", v) for v in ("pointnet", "pointnet2", "pointnet_and_pointnet2")],
    *[("pointnet2_params", v) for v in ("full", "light", "lighter", "dense")],
    *[("pose_mode", v) for v in ("quat_wxyz", "quat_xyzw", "euler_xyz", "euler_xyz_sx_cx",
                                 "rot_matrix")]])
def test_every_config_value_builds(flag, value):
    """Each value of ``pts_encoder``, ``pointnet2_params`` and ``pose_mode``
    that the JAX config takes builds a score and an energy model on the CPU
    (the pose modes with the ``R_and_T`` head, which every mode allows) whose
    feature and head outputs have the expected shapes."""
    from genpose_tpu_torch.models.posenet import build_model
    from genpose_tpu_torch.ops.pose import get_pose_dim

    kw = {flag: value, "num_points": 64}
    if flag == "pose_mode":
        kw["regression_head"] = "R_and_T"
    cfg = torch_config.Config(**kw)
    dim = get_pose_dim(cfg.pose_mode)
    pts = torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(0)) * 0.1
    for mode in ("score", "energy"):
        model = build_model(cfg, mode, device="cpu")
        with torch.no_grad():
            projs = model.precompute_head(model.encode_pts(pts))
            pose, t = torch.zeros(2, dim), torch.full((2, 1), 0.5)
            out = (model.score_with(projs, pose, t) if mode == "score"
                   else model.energy_with(projs, pose, t))
        assert out.shape == ((2, dim) if mode == "score" else (2, 2))


@pytest.mark.parametrize("ask", ["pc", "edm", "return_process", "likelihood"])
def test_frozen_agent_raises_for_what_it_has_no_program_for(ask):
    """A frozen agent serves every sampler, trajectory and likelihood a
    frozen JAX agent serves (the PC and EDM samplers, ``return_process``,
    the likelihood): each equals the eager call bit for bit, leaves the
    generator in eager's state and counts one frozen dispatch; what it has
    no program for, a sampler name neither package has, raises before any
    work (the generator untouched, no dispatch counted)."""
    from genpose_tpu_torch.training import frozen
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.utils.weights import perturb_

    cfg = torch_config.Config(num_points=32, sde_mode="edm" if ask == "edm" else "ve")
    agent = PoseAgent(cfg, "score", device="cpu")
    perturb_(agent.model, seed=1)
    gen = torch.Generator().manual_seed(0)
    batch = {"zero_mean_pts": torch.randn(1, 32, 3, generator=gen) * 0.1,
             "pts_center": torch.zeros(1, 3)}
    call = {
        "pc": lambda g: agent.sample(batch, g, repeat_num=2, sampler="pc", num_steps=3),
        "edm": lambda g: agent.sample(batch, g, repeat_num=2, sampler="edm", num_steps=3),
        "return_process": lambda g: agent.sample(batch, g, repeat_num=2, sampler="ode",
                                                 num_steps=3, return_process=True),
        "likelihood": lambda g: agent.likelihood(batch, torch.zeros(1, 9), num_steps=3),
    }[ask]

    def run():
        g = torch.Generator().manual_seed(7)
        out = call(g)
        return (out if isinstance(out, tuple) else (out,)), g.get_state()

    eager, eager_state = run()
    agent.freeze()
    dispatches = frozen.dispatches
    got, got_state = run()
    assert frozen.dispatches == dispatches + 1
    assert all(torch.equal(g, e) and torch.isfinite(g).all() for g, e in zip(got, eager))
    assert len(got) == len(eager) and torch.equal(got_state, eager_state)
    before, dispatches = gen.get_state(), frozen.dispatches
    with pytest.raises(NotImplementedError, match="sampler 'ddim'"):
        agent.sample(batch, gen, repeat_num=2, sampler="ddim", num_steps=3)
    assert torch.equal(gen.get_state(), before) and frozen.dispatches == dispatches


@pytest.mark.parametrize("bad", [{"compute_dtype": "float16"}, {"head_dtype": "fp32"},
                                 {"bn_dtype": "bfloat16"}, {"geometry_dtype": "bf16"},
                                 {"encoder_f32_stages": 6}, {"encoder_f32_stages": -6}],
                         ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_both_configs_reject_the_same_precision_values(bad):
    for module in (jax_config, torch_config):
        with pytest.raises(ValueError):
            module.Config(**bad)
