"""The metrics read inside the program (``harness/program.py``, the
readers of ``metrics/``, ``tools/program_trace.py``): each reader is found
by its name, gives None on a run without the program's records, and the
expected number on a hand-built run; idle gaps take the name of the
program span open at their midpoint; a program without the recorder gives
no recorder; the tool runs a cell on the CPU at test sizes."""

import sys
import time

import pytest
import torch

from conftest import PORTBENCH, SMALL
from harness import cellrun, common, program, trace as tracing

sys.path.insert(0, str(PORTBENCH / "tools"))
import program_trace  # noqa: E402

NAMES = ["sample_dev_ms.eval", "energy_dev_ms.eval", "eager_ms.eval", "capture_s.eval",
         "optimizer_dev_ms.train", "data_ms.train"]


def rec(id_, name, parent, root, start_ms, end_ms, device_ms=None, **attrs):
    return {"name": name, "id": id_, "parent": parent, "root": root, "attrs": attrs,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6), "device_ms": device_ms}


def requests():
    """Two requests of the program slice: 490 / 500 device ms, their
    sampler 440 / 450, their energies 10 / 12."""
    out = []
    for k, (req, smp, en) in enumerate(((490.0, 440.0, 10.0), (500.0, 450.0, 12.0))):
        b, t = 10 * k + 1, 1000.0 * k
        out += [rec(b, "serve.request", None, b, t, t + req, req, rows=256),
                rec(b + 1, "serve.copy_in", b, b, t, t + 1),
                rec(b + 2, "geometry", b, b, t + 1, t + 2),
                rec(b + 3, "sample", b, b, t + 2, t + 3, smp),
                rec(b + 4, "frozen.replay", b + 3, b, t + 2.5, t + 3, kind="sample"),
                rec(b + 5, "energy", b, b, t + 3, t + 4, en),
                rec(b + 6, "frozen.replay", b + 5, b, t + 3.5, t + 4, kind="energy"),
                rec(b + 7, "rank_pool", b, b, t + 4, t + 5),
                rec(b + 8, "serve.copy_out", b, b, t + 5, t + req)]
    return out


def steps():
    """Two training steps: data 3.0 / 5.0 device ms, optimizer 6.0 / 8.0."""
    out = []
    for k, (data, opt) in enumerate(((3.0, 6.0), (5.0, 8.0))):
        b, t = 10 * k + 1, 200.0 * k
        out += [rec(b, "data.process", None, b, t, t + 2, data),
                rec(b + 1, "train.step", None, b + 1, t + 2, t + 60, 110.0),
                rec(b + 2, "optimizer", b + 1, b + 1, t + 50, t + 60, opt)]
    return out


def setup():
    return [rec(1, "frozen.capture", None, 1, 0, 1500, kind="sample"),
            rec(2, "frozen.warmup", 1, 1, 0, 400),
            rec(3, "frozen.capture", None, 3, 2000, 2250, kind="energy"),
            rec(4, "frozen.warmup", 3, 3, 2000, 2100)]


def view(parts=None):
    v = cellrun.RunView({}, 1, 1.0, 1.0, None, None, None, {})
    if parts is not None:
        v.program = program.Program(parts, {}, (0, 0))
    return v


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_is_found_and_reads_nothing_without_records(name):
    read = cellrun.metric_reader(name)
    assert read(view()) is None                      # no program on the view
    assert read(view({})) is None                    # a program without records


def test_readers_give_the_expected_numbers():
    v = view({"setup": setup(), "slice": requests() + steps()})
    got = {n: cellrun.metric_reader(n)(v) for n in NAMES}
    assert got["sample_dev_ms.eval"] == pytest.approx(445.0)
    assert got["energy_dev_ms.eval"] == pytest.approx(11.0)
    assert got["eager_ms.eval"] == pytest.approx(((490 - 450) + (500 - 462)) / 2)
    assert got["capture_s.eval"] == pytest.approx(1.75)
    assert got["optimizer_dev_ms.train"] == pytest.approx(7.0)
    assert got["data_ms.train"] == pytest.approx(4.0)


def test_a_request_without_device_times_is_left_out():
    recs = requests()
    recs[3]["device_ms"] = None      # the first request's sampler: no device time
    v = view({"slice": recs})
    assert cellrun.metric_reader("sample_dev_ms.eval")(v) == pytest.approx(450.0)
    assert cellrun.metric_reader("eager_ms.eval")(v) == pytest.approx(500 - 462)


def test_spans_go_onto_the_profilers_clock_with_their_paths():
    # the recorder read wall 5_000_000 ns at perf-counter 1_000_000 ns
    prog = program.Program({"profiled": requests()[:5]}, {}, (5_000_000, 1_000_000))
    mapped = prog.mapped("profiled", trace_start_ns=4_000_000)
    s, e, path, r = mapped[4]
    assert path == "serve.request/sample/frozen.replay" and r["name"] == "frozen.replay"
    # 2.5 ms on the perf counter -> 2.5e6 - 1e6 + 5e6 ns wall -> 2.5e6 ns after the start
    assert s == pytest.approx(2500.0) and e == pytest.approx(3000.0)
    assert prog.profiler_us(1_000_000, 5_000_000) == pytest.approx(0.0)


def test_idle_gaps_take_the_innermost_open_span():
    spans = program.Program({"p": requests()[:9]}, {}, (0, 0)).mapped("p", 0)
    host = [("cudaGraphLaunch", 2600.0, 2700.0), ("cudaMemcpyAsync", 100_000.0, 490_000.0)]
    assert tracing.what_the_host_did(host, 2650.0) == "cudaGraphLaunch"
    assert program.gap_name(host, spans, 2650.0) == (
        "cudaGraphLaunch @ serve.request/sample/frozen.replay")
    assert program.gap_name(host, spans, 4500.0) == "host @ serve.request/rank_pool"
    assert program.gap_name(host, spans, 200_000.0) == (
        "cudaMemcpyAsync @ serve.request/serve.copy_out")
    assert program.gap_name(host, spans, 700_000.0) == "host"   # outside every span


def test_every_idle_gap_is_named_and_summed_by_span():
    spans = program.Program({"p": requests()[:9]}, {}, (0, 0)).mapped("p", 0)
    dev = [("k", 0.0, 3100.0), ("k", 3300.0, 4200.0), ("k", 4800.0, 100_000.0),
           ("k", 102_000.0, 489_000.0)]
    named = program.named_idle(dev, [], (0.0, 600_000.0), spans)
    assert [n for n, _ in named] == ["host", "host @ serve.request/serve.copy_out",
                                     "host @ serve.request/rank_pool",
                                     "host @ serve.request/energy"]
    assert [s for _, s in named] == pytest.approx([0.111, 0.002, 0.0006, 0.0002])
    by = program.idle_by_span(named)
    assert by["-"] == pytest.approx(0.111) and by["serve.request/energy"] == pytest.approx(2e-4)


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    import genpose_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "genpose_tpu_torch.utils.trace", None)
    assert program.recorder() is None


@pytest.mark.parametrize("cell,kind", [("genpose_light.eval_b256", "serve"),
                                       ("genpose_light.train_b192", "train")])
def test_the_tool_runs_a_cell_on_the_cpu(cell, kind):
    out = program_trace.run(cell, 2**33 + 5, 0.2, True, torch.device("cpu"),
                            time.perf_counter(), SMALL[kind])
    assert out["units"] >= 1 and out["units_on"] >= 1 and out["setup_s"] > 0
    assert set(program_trace.PROGRAM_METRICS[kind]) <= set(out["metrics"])
    top = {r[0] for r in out["slice_roots"]}
    assert top == ({"serve.request"} if kind == "serve" else {"data.process", "train.step"})
    assert "frozen.captures" in out["counters"] and "profiled" not in out   # no card here


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["genpose_light.eval_b256", "genpose_light.train_b192",
                                  "genpose_full.train_b192"])
def test_the_tool_on_a_card_reads_every_metric_on_one_clock(card, cell):
    kind = common.cell(cell)[2]["kind"]
    out = program_trace.run(cell, 2**31 + 103, 1.0, False, card, time.perf_counter(),
                            {"warm_units": 2})
    for name in program_trace.PROGRAM_METRICS[kind]:
        assert out["metrics"][name] is not None and out["metrics"][name] > 0, (name, out)
    clock = out["profiled"]["clock"]
    # perf-counter readings after synchronisations, once mapped, sit within
    # 50 us of the synchronisations' ends; not the first of a profiler
    # session, whose return carries CUPTI's first buffer request (~1.5 ms)
    probe = out["clock_probe"]
    assert probe["syncs_in_trace"] >= probe["readings"], probe
    assert all(abs(x) <= 50 for x in probe["reading_after_sync_us"][1:]), probe
    # no top-level span's first device operation starts before the span
    assert clock["first_op_after_span_start_us"], clock
    assert min(clock["first_op_after_span_start_us"]) >= 0, clock
    if kind == "serve":   # predict ends by copying to the host: device and host spans agree
        for name, _, host_ms, dev_ms, _ in out["slice_roots"]:
            assert abs(dev_ms - host_ms) <= 0.02 * host_ms, (host_ms, dev_ms)
        assert len(out["captures"]) == 2 and "frozen.captures" in out["counters"]
