"""The port does all that the JAX package does, name for name.

Every module of ``genpose_tpu/`` is read with ``ast`` (nothing is
imported), and each public top-level ``def`` or ``class`` must have a
counterpart: the port's module at the same path defines the same name, or
``COUNTERPARTS`` names the port's function or class that does its work
under another name or in another module (which must exist), or
``NO_COUNTERPART`` says in one line why the name has none by nature.  A
name the port simply lacks fails its module's case; so does a table entry
for a name the JAX package no longer has or the port now defines.
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
