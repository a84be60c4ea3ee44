"""``genpose_tpu_torch/utils/trace.py``: the port's spans and counters.

- Off: ``span`` hands back one shared null context, records nothing,
  allocates nothing, and costs at most 1 us (median of 10^5 calls).
- On: spans nest on a per-thread stack; a record names its parent and the
  outermost span (one request's or one step's spans share it).
- A frozen ``InferencePipeline.predict`` on the CPU and one training step
  through ``process_batch`` give the span trees the layers promise.
- ``snapshot`` holds ``frozen.captures`` and ``frozen.dispatches``;
  ``chip_smoke.py::_graph_stats`` reads capture times from the spans.
- The clock: under a CPU-activity ``torch.profiler``, an ``aten::mm`` inside
  a span lies within the span once the span is put on the profiler's
  clock with the recorder's clock pair.
- The ``cuda`` case (skips without a card): device milliseconds come back,
  no event is recorded inside a CUDA graph capture, and a frozen pipeline
  captures once per program under a ``frozen.capture`` span.  The card's
  machine runs it without JAX:
  ``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``.
"""

import itertools
import statistics
import sys
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from genpose_tpu_torch.config import Config, PtsAugConfig
from genpose_tpu_torch.data.process import process_batch
from genpose_tpu_torch.data.synthetic import synthetic_batch
from genpose_tpu_torch.runners.serving import InferencePipeline
from genpose_tpu_torch.training import frozen
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils import trace
from genpose_tpu_torch.utils.weights import perturb_

CFG = dict(num_points=64, batch_size=2, eval_repeat_num=3, sampling_steps=3, T0=0.55)


@pytest.fixture
def tracing():
    """Tracing on for one test, and off with nothing left over after it."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def tree(records, root=None):
    """The spans under ``root`` (the top-level ones when None) as nested
    (name, [children]) in the order they opened."""
    return [(r["name"], tree(records, r["id"])) for r in records if r["parent"] == root]


def _pipeline(device="cpu", cfg=CFG):
    pipe = InferencePipeline(Config(**cfg), device=device)
    perturb_(pipe.score_agent.model, seed=1)
    perturb_(pipe.energy_agent.model, seed=2)
    return pipe


def _clouds(n, n_pts=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, n_pts, 3)) * 0.1 + [0, 0, 1]).astype(np.float32)


REQUEST = [("serve.request", [
    ("serve.copy_in", []),
    ("geometry", []),
    ("sample", [("frozen.replay", [])]),
    ("energy", [("frozen.replay", [])]),
    ("rank_pool", []),
    ("serve.copy_out", []),
])]


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_hands_back_one_null_context():
    trace.drain()
    a, b = trace.span("serve.request", rows=3), trace.span("sample", device=torch.device("cpu"))
    assert a is b
    with a as got:
        assert got is None
    assert trace.drain()[0] == []


def test_off_allocates_nothing():
    span = trace.span
    for _ in range(1000):   # free lists filled, code warmed
        with span("sample"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10_000):
            with span("sample"):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before <= 0, after - before
    assert trace.drain()[0] == []


def test_off_span_costs_at_most_a_microsecond():
    span, clock = trace.span, time.perf_counter_ns
    costs = []
    for _ in range(100_000):
        t0 = clock()
        with span("sample"):
            pass
        costs.append(clock() - t0)
    assert statistics.median(costs) <= 1000, statistics.median(costs)


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------

def test_spans_nest_with_parents_and_a_shared_top_level(tracing):
    with trace.span("serve.request", rows=4):
        with trace.span("sample"):
            with trace.span("frozen.replay", kind="sample"):
                pass
        with trace.span("energy"):
            pass
    with trace.span("data.process"):
        pass
    records, counters = trace.drain()
    by = {r["name"]: r for r in records}
    req, smp, rep, en, data = (by[n] for n in ("serve.request", "sample", "frozen.replay",
                                                "energy", "data.process"))
    assert [r["name"] for r in records] == ["serve.request", "sample", "frozen.replay", "energy",
                                            "data.process"]
    assert req["parent"] is None and req["root"] == req["id"] and req["attrs"] == {"rows": 4}
    assert smp["parent"] == req["id"] and en["parent"] == req["id"]
    assert rep["parent"] == smp["id"] and rep["attrs"] == {"kind": "sample"}
    assert {smp["root"], rep["root"], en["root"]} == {req["id"]}
    assert data["parent"] is None and data["root"] == data["id"] != req["id"]
    assert req["start_ns"] <= smp["start_ns"] <= rep["start_ns"] <= rep["end_ns"]
    assert rep["end_ns"] <= smp["end_ns"] <= en["start_ns"] <= en["end_ns"] <= req["end_ns"]
    assert all(r["device_ms"] is None for r in records)   # no CUDA device given
    assert "frozen.dispatches" in counters and trace.drain()[0] == []


def test_spanned_decorator_tests_the_flag_at_each_call():
    @trace.spanned("train.step", device=lambda x: torch.device("cpu"))
    def step(x):
        with trace.span("optimizer"):
            return x + 1

    trace.drain()
    assert step(1) == 2 and trace.drain()[0] == []
    trace.enable()
    try:
        assert step(2) == 3
    finally:
        trace.disable()
    records, _ = trace.drain()
    assert tree(records) == [("train.step", [("optimizer", [])])]


def test_each_thread_keeps_its_own_stack(tracing):
    def work():
        with trace.span("data.process"):
            time.sleep(0.01)

    with trace.span("train.step"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    records, _ = trace.drain()
    assert sorted(tree(records)) == [("data.process", []), ("train.step", [])]


def test_a_span_closed_by_an_exception_is_recorded(tracing):
    with pytest.raises(ValueError):
        with trace.span("serve.request"):
            with trace.span("sample"):
                raise ValueError("refused")
    with trace.span("data.process"):
        pass
    records, _ = trace.drain()
    assert tree(records) == [("serve.request", [("sample", [])]), ("data.process", [])]


# ---------------------------------------------------------------------------
# the layers' spans
# ---------------------------------------------------------------------------

def test_frozen_predict_gives_the_request_tree(tracing):
    pipe = _pipeline().freeze()
    pts = _clouds(2)
    trace.disable()
    pipe.predict(pts)                  # the programs made, untraced
    trace.drain()
    d0 = trace.snapshot()
    trace.enable()
    pipe.predict(pts, generator=torch.Generator().manual_seed(3))
    records, counters = trace.drain()
    assert tree(records) == REQUEST
    assert len({r["root"] for r in records}) == 1
    assert records[0]["attrs"] == {"rows": 2}
    assert counters["frozen.dispatches"] == d0["frozen.dispatches"] + 2
    # the CPU runs the frozen programs uncaptured: nothing is captured
    assert counters["frozen.captures"] == d0["frozen.captures"]


def test_chunked_request_repeats_its_chunk_spans(tracing):
    pipe = _pipeline().freeze()
    pipe.predict(_clouds(3))
    records, _ = trace.drain()
    (name, children), = tree(records)
    assert name == "serve.request" and records[0]["attrs"] == {"rows": 3}
    assert [c[0] for c in children] == [c[0] for c in REQUEST[0][1]] * 2


def test_training_step_through_process_batch_gives_its_trees(tracing):
    cfg = Config(num_points=64, batch_size=4, repeat_num=2,
                 pts_aug=PtsAugConfig(aug_pc_pro=1.0, aug_rt_pro=1.0, aug_bb_pro=1.0,
                                      aug_bc_pro=1.0))
    agent = PoseAgent(cfg, "score", device="cpu")
    raw = synthetic_batch(np.random.default_rng(0), bs=4, n_pts=64, n_model=128)
    gen = torch.Generator().manual_seed(0)
    batch = process_batch(raw, cfg.pose_mode, generator=gen, pts_aug_params=cfg.pts_aug,
                          device="cpu")
    agent.train_step(batch, generator=gen)
    agent.ema_loss(batch, generator=gen)
    records, _ = trace.drain()
    assert tree(records) == [("data.process", []), ("train.step", [("optimizer", [])]),
                             ("train.ema_loss", [])]
    assert len({r["root"] for r in records}) == 3


def test_snapshot_holds_every_counter():
    got = trace.snapshot()
    assert {"frozen.captures", "frozen.dispatches", "fps.launches", "ball_query.launches",
            "fps_bq_fused.launches"} <= set(got)
    assert got["frozen.dispatches"] == frozen.dispatches
    trace.count("frozen.captures", 0)
    assert trace.snapshot()["frozen.captures"] == got["frozen.captures"]


def test_chip_smoke_reads_capture_times_from_the_spans():
    """``chip_smoke.py::_graph_stats`` takes warm-up and capture seconds from
    the ``frozen.capture`` spans of a phase run under ``_traced()``: the
    warm-up its ``frozen.warmup`` child, the capture the rest."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    with chip_smoke._traced() as records:
        with trace.span("frozen.capture", mode="score", kind="sample", rows=64, K=50, graphs=1):
            with trace.span("frozen.warmup"):
                time.sleep(0.02)
            time.sleep(0.01)
    got = chip_smoke._graph_stats(records)
    assert list(got) == ["score sample 64x50"] and got["score sample 64x50"]["graphs"] == 1
    assert 0.02 <= got["score sample 64x50"]["warmup_s"] < 0.2
    assert 0.01 <= got["score sample 64x50"]["capture_s"] < 0.2
    assert trace.span("x") is trace.span("y")        # off again after the phase


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------

def test_spans_fall_on_the_profilers_clock(tracing):
    a = torch.randn(128, 128)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    records, _ = trace.drain()
    base = prof.profiler.kineto_results.trace_start_ns()
    wall, perf = trace.clock()
    (rec,) = records
    s_us = (rec["start_ns"] - perf + wall - base) / 1e3
    e_us = (rec["end_ns"] - perf + wall - base) / 1e3
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    assert s_us <= mm.time_range.start <= mm.time_range.end <= e_us, (
        s_us, mm.time_range.start, mm.time_range.end, e_us)
    # the ends lie the sleeps' 2 ms apart from the product, not seconds
    assert mm.time_range.start - s_us < 50_000 and e_us - mm.time_range.end < 50_000


def test_the_clock_pair_is_read_back_to_back(tracing):
    w = time.time_ns()
    m = time.perf_counter_ns()
    wall, perf = trace.clock()
    assert abs((m - perf + wall) - w) < 1_000_000


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_device_time_and_no_event_inside_a_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x @ x                          # cuBLAS initialised before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    trace.drain()
    trace.enable()
    try:
        with trace.span("timed", device=dev):
            for _ in range(20):
                x = x @ x / 2048
        with torch.cuda.graph(graph):
            with trace.span("captured", device=dev):
                y = x @ x
        graph.replay()
        records, _ = trace.drain()
    finally:
        trace.disable()
    by = {r["name"]: r for r in records}
    assert by["timed"]["device_ms"] > 0.1 and torch.isfinite(y).all()
    assert by["captured"]["device_ms"] is None


@pytest.mark.cuda
def test_frozen_pipeline_on_a_card_captures_under_its_span():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    dev = torch.device("cuda")
    pipe = _pipeline(dev, dict(CFG, num_points=1024)).freeze()
    pts = _clouds(2, n_pts=1024)
    c0 = trace.snapshot()
    trace.drain()
    trace.enable()
    try:
        pipe.predict(pts)              # captures the sample and energy programs
        first, _ = trace.drain()
        pipe.predict(pts)              # replays them
        second, counters = trace.drain()
    finally:
        trace.disable()
    assert counters["frozen.captures"] == c0["frozen.captures"] + 2
    assert counters["frozen.dispatches"] == c0["frozen.dispatches"] + 4
    caps = [r for r in first if r["name"] == "frozen.capture"]
    assert sorted(r["attrs"]["kind"] for r in caps) == ["energy", "sample"]
    for cap in caps:
        kids = [r for r in first if r["parent"] == cap["id"]]
        assert [k["name"] for k in kids] == ["frozen.warmup"] and cap["device_ms"] is None
    assert tree(second) == REQUEST
    by = {r["name"]: r for r in second}
    req = by["serve.request"]
    host_ms = (req["end_ns"] - req["start_ns"]) / 1e6
    # predict ends by copying to the host, so the device span and the host
    # span agree; the sampler and the energies lie inside the request
    assert abs(req["device_ms"] - host_ms) <= 0.02 * host_ms + 0.5, (req["device_ms"], host_ms)
    assert 0 < by["sample"]["device_ms"] + by["energy"]["device_ms"] <= req["device_ms"]
