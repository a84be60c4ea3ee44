"""What the benchmark runs loads neither JAX nor the JAX package, compared
by whole top-level names (``genpose_tpu_torch`` is not ``genpose_tpu``); the
reference loads nothing of the program; nothing reads the JAX-era files."""

import ast
import subprocess
import sys

import pytest

from harness import common

SOURCES = sorted(p for p in common.ROOT.rglob("*.py") if "tests" not in p.parts)
JAX_ERA = ["bench" + ".py", "BENCH_", "MULTICHIP_", "BASELINE" + ".json", "bench_" + "evidence"]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(common.ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = set(imported(path))
    assert not names & common.FORBIDDEN
    if "reference" in path.parts:
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names
    assert not any(s in path.read_text() for s in JAX_ERA)


def test_the_check_compares_whole_names(monkeypatch):
    for name in ("genpose_tpu_torch", "genpose_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    base = set(common.forbidden_loaded())
    assert not base & {"genpose_tpu", "jax", "flax"}
    monkeypatch.setitem(sys.modules, "genpose_tpu.ops.pose", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(common.forbidden_loaded()) - base == {"genpose_tpu", "jax"}


def test_a_run_loads_none_of_them():
    """A cell run at test sizes on the CPU in a fresh interpreter, then the
    run's own check of ``sys.modules``."""
    probe = (
        "import sys, time; sys.path[:0] = ['portbench', '.']\n"
        "import torch\n"
        "from harness import common\n"
        "from harness.cellrun import run_cell\n"
        "run_cell('genpose_light.eval_b256', 5, 0.1, False, torch.device('cpu'),"
        " time.perf_counter(),"
        " dict(batch=2, points=64, hypotheses=3, steps=3, check_units=1, warm_units=1))\n"
        "print('loaded', common.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=common.CHECKOUT, capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "loaded []" in out.stdout
