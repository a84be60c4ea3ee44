"""The port does all that the JAX package does, name for name.

Every module of ``genpose_tpu/`` is read with ``ast`` (nothing is
imported), and each public top-level ``def`` or ``class`` must have a
counterpart: the port's module at the same path defines the same name, or
``COUNTERPARTS`` names the port's function or class that does its work
under another name or in another module (which must exist), or
``NO_COUNTERPART`` says in one line why the name has none by nature.  A
name the port simply lacks fails its module's case; so does a table entry
for a name the JAX package no longer has or the port now defines.

The repository's root ``tools/`` are held alike: each script that uses the
JAX package (``genpose_tpu`` named in its text) is in ``ROOT_TOOLS``, with
its port counterpart (which must exist), or in ``ROOT_TOOLS_WITHOUT`` with
one line saying why it has none yet.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "genpose_tpu"
PORT = ROOT / "genpose_tpu_torch"
JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))

# JAX "module::name" -> the port's "module::name" that does its work
COUNTERPARTS = {
    "diffusion/sde.py::vp_prior": ["diffusion/sde.py::unit_prior"],
    "diffusion/sde.py::subvp_prior": ["diffusion/sde.py::unit_prior"],
    "eval/metrics.py::pose_errors_jax": ["eval/metrics.py::pose_errors"],
    "models/layers.py::TorchBatchNorm": ["models/layers.py::batch_norm",
                                         "models/layers.py::global_batch_norm"],
    # the port's helper never falls back: it builds or raises, and the one
    # question before it is whether the caller switched it off
    "native/__init__.py::available": ["native/__init__.py::disabled"],
    "ops/fps_pallas.py::fps_pallas": ["ops/fps_cuda.py::fps_cuda"],
    "ops/ball_query_pallas.py::ball_query_pallas": ["ops/ball_query_cuda.py::ball_query_cuda"],
    "ops/fps_bq_fused.py::fps_bq_fused": ["ops/fps_bq_fused_cuda.py::fps_bq_fused_cuda"],
    "parallel/mesh.py::make_mesh": ["parallel/group.py::make_group"],
    "parallel/mesh.py::batch_sharding": ["parallel/group.py::shard_batch"],
    "parallel/mesh.py::shard_batch": ["parallel/group.py::shard_batch"],
    "parallel/mesh.py::replicate": ["parallel/group.py::replicate"],
    "parallel/mesh.py::pad_to_multiple": ["parallel/group.py::pad_to_multiple"],
    "utils/benchmarking.py::derandomize_state": ["utils/benchmarking.py::derandomize_"],
    "utils/benchmarking.py::flops_from_cost": ["utils/benchmarking.py::flops_of"],
}

# JAX "module::name" -> why the port has no counterpart
NO_COUNTERPART = {
    "config.py::enable_compile_cache": "turns on XLA's persistent compilation cache; PyTorch's "
                                       "eager and CUDA-graph paths compile nothing to cache",
    "models/layers.py::zero_dense": "a flax Dense constructor with a zero kernel initialiser; "
                                    "the port's tails create their zeroed output parameters",
    "models/posenet.py::make_encode_fn": "a closure over flax (model, variables); the port "
                                         "calls the module's encode_pts",
    "models/posenet.py::make_score_fn": "a closure over flax (model, variables); the port calls "
                                        "the module's precompute_head and score_with",
    "models/posenet.py::make_energy_fn": "a closure over flax (model, variables); the port "
                                         "calls the module's energy_with",
    "ops/pointcloud.py::one_hot_gather": "a row gather as a one-hot matmul for the TPU's MXU; "
                                         "the port gathers by indexing",
}


# root tools/ script -> the port's counterpart, relative to the repository
ROOT_TOOLS = {
    "tpu_convergence_check.py": "genpose_tpu_torch/tools/convergence_check.py",
    "bench_fused_geometry.py": "genpose_tpu_torch/tools/bench_fused_geometry.py",
    "port_torch_ckpt.py": "genpose_tpu_torch/tools/port_torch_ckpt.py",
    "real275_parity_runbook.sh": "genpose_tpu_torch/tools/real275_parity_runbook.sh",
}

_MEASURED = "measured by chip_smoke.py phases; queued for the benchmark PR"
# root tools/ script -> why the port has no counterpart yet
ROOT_TOOLS_WITHOUT = {
    "orbax_to_port.py": "the bridge itself: reads a JAX checkpoint where JAX runs and writes "
                        "the port's format, which training/checkpoints.py loads",
    "profile_pipeline.py": _MEASURED,
    "profile_train.py": _MEASURED,
    "profile_energy_train.py": _MEASURED,
    "profile_geometry.py": _MEASURED,
    "profile_bs1.py": _MEASURED,
    "bench_ballquery.py": _MEASURED,
    "bench_s0_variants.py": _MEASURED,
    "bench_freeze_ab.py": _MEASURED,
    "bench_loader.py": _MEASURED,
    "bench_trainer_e2e.py": _MEASURED,
}


def _root_tools_using_jax() -> list:
    return sorted(p.name for p in (ROOT / "tools").iterdir()
                  if p.suffix in (".py", ".sh") and re.search(r"\bgenpose_tpu\b", p.read_text()))


def _public_names(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defined_names(path: Path) -> set:
    """Names a module binds at top level: functions, classes, assignments."""
    if not path.exists():
        return set()
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port_names = _defined_names(PORT / module)
    for name in _public_names(JAX / module):
        key = f"{module}::{name}"
        if key in COUNTERPARTS:
            assert name not in port_names, f"{key}: the port defines it; drop the table entry"
            for target in COUNTERPARTS[key]:
                where, _, what = target.partition("::")
                assert what in _defined_names(PORT / where), f"{key}: {target} is missing"
        elif key in NO_COUNTERPART:
            assert name not in port_names, f"{key}: the port defines it; drop the table entry"
            assert NO_COUNTERPART[key].strip()
        else:
            assert name in port_names, f"{key} has no counterpart in genpose_tpu_torch/{module}"


def test_table_names_exist_in_the_jax_package():
    for key in [*COUNTERPARTS, *NO_COUNTERPART]:
        module, _, name = key.partition("::")
        assert name in _public_names(JAX / module), f"{key}: no such JAX public name"
    assert not set(COUNTERPARTS) & set(NO_COUNTERPART)


def test_host_helper_has_every_c_entry_point():
    """The port's ``native/preprocess.cpp`` exports the C functions of the
    JAX package's, with the same parameter lists."""
    def entry_points(path: Path) -> dict:
        src = path.read_text()
        return {m.group(2): " ".join(m.group(3).split())
                for m in re.finditer(r"^(int|void) (gp_\w+)\(([^)]*)\)", src, re.M)}

    want = entry_points(JAX / "native" / "preprocess.cpp")
    assert len(want) == 5
    assert entry_points(PORT / "native" / "preprocess.cpp") == want


def test_every_root_tool_has_an_entry():
    """A root tool that uses the JAX package names its port counterpart or
    says why it has none; no entry names a tool that is gone."""
    tools = _root_tools_using_jax()
    assert not set(ROOT_TOOLS) & set(ROOT_TOOLS_WITHOUT)
    assert sorted([*ROOT_TOOLS, *ROOT_TOOLS_WITHOUT]) == tools
    for name, port in ROOT_TOOLS.items():
        assert (ROOT / port).is_file(), f"tools/{name}: {port} is missing"
    assert all(why.strip() for why in ROOT_TOOLS_WITHOUT.values())
