"""Every cell, run on the card as the driver runs it, once without and once
with tracing, with short windows.  Marked ``cuda``; on the card:

    python -m pytest portbench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from harness import cellrun, common

BENCH = json.loads((common.CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_is_correct_and_reports_its_metrics(card, cell, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
                         cwd=common.CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert set(result["metrics"]) == set(cellrun.cell_metrics(cell, e2e))
        for name, m in result["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
    else:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
