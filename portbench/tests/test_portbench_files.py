"""The benchmark's files parse, agree with BENCHMARK.json, keep to the
contract's shapes, and a new one is found by its name alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from harness import cellrun, common

ROOT = common.ROOT
BENCH = json.loads((common.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    texts = ([x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
             + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "traffic", "cells", "kernels"])
def test_every_data_file_parses(kind):
    files = common.names(kind)
    assert files
    for name in files:
        assert isinstance(common.load(kind, name), dict)


def test_configs_are_whole_and_in_benchmark():
    for c in BENCH["configs"]:
        data = json.loads((common.CHECKOUT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/") and data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["num_points"] == 1024 and data["compute_dtype"] == "float32"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_names_its_files_and_reports_its_metrics(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c, config, traffic = common.cell(cell)
    assert (c["config"], c["traffic"]) == (w["config"], w["traffic"]) and w["chips"] == 1
    assert c["limits"] and all(v > 0 for v in c["limits"].values())
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if m.get("workloads") is None or cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cellrun.cell_metrics(cell, e2e)
    assert per_layer
    for name in per_layer:
        m = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert m["moves"] in e2e
        assert callable(cellrun.metric_reader(name))


def test_every_per_layer_metric_has_its_reader_and_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        stem = m["name"].split(".")[0]
        assert any((ROOT / "metrics" / f"{n}.py").is_file() for n in (m["name"], stem))
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_kernel_patterns_group_by_stage():
    pats = cellrun.kernel_patterns()
    assert {"fps_kernel", "ball_query_kernel"} <= set(pats["geometry"])


def test_new_files_are_found_by_name_without_editing_any(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell, a metric and a
    kernel pattern as new files (and the cell's entries in BENCHMARK.json);
    the harness finds each by its name, and a metric whose stem has a
    reader (``mfu.eval_b64``) needs no file of its own."""
    shutil.copytree(ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "genpose_light.eval_b64", "config": "genpose_light", "traffic": "eval_b64",
         "chips": 1, "why": "a smaller batch"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "request_ms.eval_b64", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "serving", "moves": "poses_per_s",
         "workloads": ["genpose_light.eval_b64"]},
        {"name": "mfu.eval_b64", "unit": "%", "better": "higher", "source": "program_span",
         "layer": "whole step", "moves": "poses_per_s", "workloads": ["genpose_light.eval_b64"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    traffic = json.loads((pb / "traffic" / "eval_b256.json").read_text())
    (pb / "traffic" / "eval_b64.json").write_text(json.dumps({**traffic, "batch": 64}))
    (pb / "cells" / "genpose_light.eval_b64.json").write_text(json.dumps(
        {"config": "genpose_light", "traffic": "eval_b64", "limits": {"pose_gap": 1e-4}}))
    (pb / "metrics" / "request_ms.eval_b64.py").write_text(
        'def read(run):\n    return run.span_mean_ms("request")\n')
    (pb / "kernels" / "fused_geometry.json").write_text(
        json.dumps({"stage": "geometry", "pattern": "fused_geometry_kernel"}))
    probe = (
        "import sys; sys.path.insert(0, 'portbench')\n"
        "from harness import cellrun, common\n"
        "c, config, traffic = common.cell('genpose_light.eval_b64')\n"
        "assert traffic['batch'] == 64 and config['name'] == 'genpose_light'\n"
        "m = cellrun.cell_metrics('genpose_light.eval_b64', ['poses_per_s', 'setup_s'])\n"
        "assert m == ['request_ms.eval_b64', 'mfu.eval_b64'], m\n"
        "class V:\n"
        "    span_mean_ms = staticmethod(lambda n: 12.5)\n"
        "    mfu_pct = staticmethod(lambda: 31.0)\n"
        "assert cellrun.metric_reader('request_ms.eval_b64')(V) == 12.5\n"
        "assert cellrun.metric_reader('mfu.eval_b64')(V) == 31.0\n"
        "assert 'fused_geometry_kernel' in cellrun.kernel_patterns()['geometry']\n"
        "print('found')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    """No card here: exit 2 and no result line; in a directory of the
    benchmark alone it cannot run either."""
    out = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload",
                          "genpose_light.eval_b256", "--seed", "3000000000", "--seconds", "1",
                          "--trace", "0"], cwd=common.CHECKOUT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.CHECKOUT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "genpose_light.eval_b256", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["genpose_light", "genpose_full"])
def test_the_reference_computes_the_configuration_it_is_given(name):
    from reference import genpose_ref as ref

    c = common.load("configs", name)
    assert (c["sigma_min"], c["sigma_max"], c["sde_eps"]) == (ref.SIGMA_MIN, ref.SIGMA_MAX,
                                                             ref.SDE_EPS)
    assert (c["tail_hidden"], c["feature_dim"], c["t_embed_dim"], c["pose_feature_dim"]) == (
        ref.TAIL_HIDDEN, ref.FEAT_DIM, ref.T_DIM, ref.POSE_FEAT)
    ref.Ref(c)   # refuses a head, pose mode, SDE or energy it does not compute
