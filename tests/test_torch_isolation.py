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
                 "genpose_tpu_torch/tools/port_torch_ckpt.py"):
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
    from genpose_tpu_torch.runners.serving import InferencePipeline
    from genpose_tpu_torch.training.agent import PoseAgent

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config.Config(num_points=32)
    for make in (lambda: InferencePipeline(cfg), lambda: PoseAgent(cfg),
                 lambda: build_model(cfg), lambda: PoseAgent(cfg, device="cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    model = build_model(cfg, "score", device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_unported_configurations_raise():
    from genpose_tpu_torch.models.posenet import build_model

    Config = torch_config.Config
    for cfg in (Config(pointnet2_params="full"), Config(pts_encoder="pointnet"),
                Config(pose_mode="euler_xyz", regression_head="RT")):
        with pytest.raises(NotImplementedError):
            build_model(cfg, "score", device="cpu")


@pytest.mark.parametrize("ask", ["pc", "edm", "return_process", "likelihood"])
def test_frozen_agent_raises_for_what_it_has_no_program_for(ask):
    """A frozen agent serves ``ode`` and ``ode_adaptive``; asked for the PC
    or EDM sampler, a trajectory or a likelihood it raises, naming what was
    asked, before any work, and never runs eagerly behind the caller's back;
    once its weights change it is no longer frozen and runs them eagerly."""
    from genpose_tpu_torch.training import frozen
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.utils.weights import perturb_

    cfg = torch_config.Config(num_points=32, sde_mode="edm" if ask == "edm" else "ve")
    agent = PoseAgent(cfg, "score", device="cpu").freeze()
    gen = torch.Generator().manual_seed(0)
    batch = {"zero_mean_pts": torch.randn(1, 32, 3, generator=gen) * 0.1,
             "pts_center": torch.zeros(1, 3)}
    before, dispatches = gen.get_state(), frozen.dispatches
    call = {
        "pc": lambda: agent.sample(batch, gen, repeat_num=2, sampler="pc", num_steps=3),
        "edm": lambda: agent.sample(batch, gen, repeat_num=2, sampler="edm", num_steps=3),
        "return_process": lambda: agent.sample(batch, gen, repeat_num=2, sampler="ode",
                                               num_steps=3, return_process=True),
        "likelihood": lambda: agent.likelihood(batch, torch.zeros(1, 9), num_steps=3),
    }[ask]
    with pytest.raises(NotImplementedError, match="frozen path has no"):
        call()
    assert torch.equal(gen.get_state(), before) and frozen.dispatches == dispatches
    perturb_(agent.model, seed=1)  # the weights change: the agent runs eagerly
    out = call()
    assert all(torch.isfinite(o).all() for o in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("bad", [{"compute_dtype": "float16"}, {"head_dtype": "fp32"},
                                 {"bn_dtype": "bfloat16"}, {"geometry_dtype": "bf16"},
                                 {"encoder_f32_stages": 6}, {"encoder_f32_stages": -6}],
                         ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_both_configs_reject_the_same_precision_values(bad):
    for module in (jax_config, torch_config):
        with pytest.raises(ValueError):
            module.Config(**bad)
