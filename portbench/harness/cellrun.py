"""One run of one cell: set-up, the measured window, with ``trace`` a slice
under synchronised spans and a profiled slice after it, then the program
freed and the check against the reference.  Returns the result line's
fields and the compared numbers."""

from __future__ import annotations

import importlib
import importlib.util
import math
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import common, trace as tracing, work

class RunView:
    """What a per-layer metric reads: the spans (ms per call, by name) of
    the span slice, the measured window's units and seconds,
    the work per unit, the card's peaks, and the profiled slice's summary
    and geometry work."""

    def __init__(self, spans, units, window_s, ops_per_unit, peak, summary, geometry_least_s,
                 patterns):
        self.spans = spans
        self.units, self.window_s, self.ops_per_unit = units, window_s, ops_per_unit
        self.peak, self.summary = peak, summary
        self.geometry_least_s, self.patterns = geometry_least_s, patterns

    def span_mean_ms(self, name: str) -> Optional[float]:
        v = self.spans.get(name)
        return float(np.mean(v)) if v else None

    def mfu_pct(self) -> Optional[float]:
        if self.peak is None or not self.units:
            return None
        rate = self.ops_per_unit * self.units / self.window_s
        return 100.0 * rate / self.peak["float32_ops_per_s"]

    def idle_pct(self) -> Optional[float]:
        if self.summary is None:
            return None
        return 100.0 * (1.0 - self.summary["busy_s"] / self.summary["window_s"])

    def roofline_pct(self, stage: str) -> Optional[float]:
        pats = self.patterns.get(stage)
        if self.summary is None or not pats or not self.geometry_least_s:
            return None
        dev_s = tracing.stage_seconds(self.summary, pats)
        return 100.0 * self.geometry_least_s / dev_s if dev_s > 0 else None


def kernel_patterns() -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for name in common.names("kernels"):
        k = common.load("kernels", name)
        out.setdefault(k["stage"], []).append(k["pattern"])
    return out


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``, else of ``metrics/<stem>.py`` (the
    name up to its first dot): ``mfu.eval`` and ``mfu.train`` share
    ``mfu.py``."""
    path = common.ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        path = common.ROOT / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(workload: str, end_to_end: List[str]) -> List[str]:
    """The per-layer metrics BENCHMARK.json gives this cell: those that list
    it, and those without a list whose end-to-end metric it reports."""
    out = []
    for m in common.benchmark()["per_layer"]:
        cells = m.get("workloads")
        if (workload in cells) if cells is not None else (m["moves"] in end_to_end):
            out.append(m["name"])
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, traffic_overrides: Optional[Dict] = None) -> Dict:
    cell, config, traffic = common.cell(workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    driver_mod = importlib.import_module(f"harness.{traffic['kind']}")
    spans = common.Spans(device)
    d = driver_mod.Driver(config, traffic, device, seed, spans)
    d.setup()
    # units before the window, part of set-up: every shape met once, and for
    # serving the ~20 s after which requests run at their steady pace
    for i in range(traffic.get("warm_units", 1)):
        d.warm(i)
    d.start()

    # the measured window: units back to back until ``seconds`` have passed,
    # the same loop with and without ``trace``
    latencies, units = [], 0
    common.sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        lat = d.unit(units)
        latencies.append(lat)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    window_s = time.perf_counter() - t0
    e2e = d.end_to_end(units, window_s, latencies)
    timed = [x for x in latencies if x is not None]
    if timed:
        q = np.percentile(np.asarray(timed) * 1e3, [5, 50, 95, 99, 100])
        print(f"window {window_s:.3f} s, {units} units; unit ms p5 p50 p95 p99 max "
              + " ".join(f"{v:.3f}" for v in q), file=sys.stderr, flush=True)

    summary = None
    if trace:
        # the spans' slice: each spanned call synchronised on both sides
        spans.on = True
        n_spans = traffic["span_units"]
        for i in range(units, units + n_spans):
            d.unit(i)
        spans.on = False
        # the profiled slice, unsynchronised as the window's units are
        summary = tracing.profile(
            lambda: d.profiled(units + n_spans, traffic["profile_units"]), device)
    spans.unwrap()
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    d.close(units)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        numbers = d.check()
    except Exception:  # an output the check cannot read is not correct
        traceback.print_exc()
        numbers = {}
    correct, checks = common.judge(numbers, cell["limits"])

    units_e2e = {m["name"]: m["unit"] for m in common.benchmark()["end_to_end"]}
    metrics = {name: {"value": v, "unit": units_e2e[name]} for name, v in e2e.items()}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    cuda = device.type == "cuda"
    out = {"correct": correct, "attempted": units, "failed": 0,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(memory)}}
    if not trace:
        out["metrics"] = metrics
        return {"result": out, "checks": checks, "numbers": numbers}

    peak = common.peaks(device)
    least = None
    if peak is not None:
        ops = nbytes = 0.0
        for xyz in d.geometry_clouds():
            o, b = work.geometry_work(config["encoder_stages"], xyz)
            ops, nbytes = ops + o, nbytes + b
        least = work.least_seconds(ops, nbytes, peak)
    view = RunView(spans.ms, units, window_s,
                   d.ops_per_unit(), peak, summary, least, kernel_patterns())
    per_layer = {}
    units_of = {m["name"]: m["unit"] for m in common.benchmark()["per_layer"]}
    for name in cell_metrics(workload, list(e2e)):
        v = metric_reader(name)(view)
        if v is not None and math.isfinite(v):
            per_layer[name] = {"value": v, "unit": units_of[name]}
    out["metrics"] = per_layer
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": tracing.top_ops(summary),
                            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
    return {"result": out, "checks": checks, "numbers": numbers, "e2e": metrics}

