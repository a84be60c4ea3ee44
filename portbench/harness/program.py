"""The program's own spans and counters in one run, as the per-layer
metrics that read inside the program take them.

The port records spans at its layer boundaries and keeps its counters in
``genpose_tpu_torch/utils/trace.py`` (the recorder).  A run turns the
recorder on for three parts only: set-up (``"setup"``), a slice of units
run with neither synchronisation nor the profiler (``"slice"``: device
times are read here, away from the profiler's buffer flushes), and the
profiled slice (``"profiled"``: its spans only name idle gaps).  The
measured window runs with the recorder off.

A checkout whose program has no recorder gives no records: ``recorder()``
is None and every reader of ``metrics/`` that reads a ``Program`` gives
None.

Clocks: a record's host times are ``perf_counter_ns``; the recorder's
(wall, perf-counter) pair puts them on the wall clock, which the
profiler's events share (microseconds after ``trace_start_ns``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import common, trace as tracing


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from genpose_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


class Program:
    """The records of each part of a run, the counters at its end, and the
    recorder's (wall ns, perf-counter ns) clock pair."""

    def __init__(self, parts: Dict[str, List[Dict]], counters: Dict[str, int],
                 clock: Tuple[int, int]):
        self.parts, self.counters, self.clock = parts, counters, clock

    def records(self, part: str, name: Optional[str] = None) -> List[Dict]:
        return [r for r in self.parts.get(part, []) if name is None or r["name"] == name]

    def per_root_ms(self, part: str, root: str, names) -> List[float]:
        """For each top-level span named ``root`` of ``part``: its device ms
        less the device ms of the spans named in ``names`` under it."""
        recs = self.parts.get(part, [])
        out = []
        for r in recs:
            if r["name"] != root or r["device_ms"] is None:
                continue
            inner = [x["device_ms"] for x in recs
                     if x["root"] == r["id"] and x["name"] in names]
            if any(v is None for v in inner):
                continue
            out.append(r["device_ms"] - sum(inner))
        return out

    def root_sum_ms(self, part: str, root: str, name: str) -> List[float]:
        """For each top-level span named ``root``: the device ms of the
        spans named ``name`` under it, summed."""
        recs = self.parts.get(part, [])
        out = []
        for r in recs:
            if r["name"] != root:
                continue
            inner = [x["device_ms"] for x in recs if x["root"] == r["id"] and x["name"] == name]
            if inner and all(v is not None for v in inner):
                out.append(sum(inner))
        return out

    def device_ms(self, part: str, name: str) -> List[float]:
        return [r["device_ms"] for r in self.records(part, name) if r["device_ms"] is not None]

    def host_s(self, part: str, name: str) -> List[float]:
        return [(r["end_ns"] - r["start_ns"]) / 1e9 for r in self.records(part, name)]

    def profiler_us(self, perf_ns: int, trace_start_ns: int) -> float:
        """A perf-counter reading on the profiler's clock (us after its start)."""
        wall, perf = self.clock
        return (perf_ns - perf + wall - trace_start_ns) / 1e3

    def mapped(self, part: str, trace_start_ns: int) -> List[Tuple[float, float, str, Dict]]:
        """Each span of ``part`` as (start us, end us, path, record) on the
        profiler's clock; the path names it and the spans around it
        (``serve.request/sample/frozen.replay``)."""
        recs = self.parts.get(part, [])
        by_id = {r["id"]: r for r in recs}
        out = []
        for r in recs:
            names, at = [], r
            while at is not None:
                names.append(at["name"])
                at = by_id.get(at["parent"])
            out.append((self.profiler_us(r["start_ns"], trace_start_ns),
                        self.profiler_us(r["end_ns"], trace_start_ns),
                        "/".join(reversed(names)), r))
        return out


def mean(values: List[float]) -> Optional[float]:
    return float(np.mean(values)) if values else None


def program_of(run) -> Optional[Program]:
    """The ``Program`` a run view carries, or None (a view without one, or
    a program without the recorder)."""
    return getattr(run, "program", None)


# ---------------------------------------------------------------------------
# idle gaps named by program span
# ---------------------------------------------------------------------------

def innermost(spans, at: float) -> Optional[str]:
    """The path of the innermost span open at ``at`` (us on the profiler's
    clock), or None when none is open.  ``spans``: ``Program.mapped``."""
    open_ = [(e - s, path) for s, e, path, _ in spans if s <= at <= e]
    return min(open_)[1] if open_ else None


def gap_name(host, spans, at: float) -> str:
    """``what_the_host_did`` at ``at``, and where a program span was open
    there, `` @ `` and the innermost one's path."""
    name = tracing.what_the_host_did(host, at)
    path = innermost(spans, at)
    return name if path is None else f"{name} @ {path}"


def idle_gaps(dev, window) -> List[Tuple[float, float]]:
    """Every interval of the window (us) in which no operation ran on the
    device."""
    w0, w1 = window
    busy = tracing.union([(max(s, w0), min(e, w1)) for _, s, e in dev if e > w0 and s < w1])
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    return gaps


def named_idle(dev, host, window, spans) -> List[Tuple[str, float]]:
    """Every idle gap as (its name, seconds), longest first."""
    gaps = sorted(idle_gaps(dev, window), key=lambda g: g[0] - g[1])
    return [(gap_name(host, spans, (s + e) / 2), (e - s) / 1e6) for s, e in gaps]


def idle_by_span(named: List[Tuple[str, float]]) -> Dict[str, float]:
    """Idle seconds by the span path after `` @ `` (``-`` where none was open)."""
    out: Dict[str, float] = {}
    for name, s in named:
        key = name.split(" @ ", 1)[1] if " @ " in name else "-"
        out[key] = out.get(key, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# the profiled slice, with the program's spans
# ---------------------------------------------------------------------------

def profile(fn, device: torch.device, rec) -> Optional[Dict]:
    """``fn`` under the profiler (CUDA activity alone) between two
    synchronisations, with the recorder on, as ``harness/trace.py::profile``
    takes its slice: what that gives (``summary``, its ten longest gaps
    named with `` @ `` spans), the slice's records, idle seconds by span,
    the share of idle seconds that fell inside a span, and the clock
    checks.  None off a card (``fn`` run, nothing profiled) or when the
    trace holds no device operation."""
    rec.drain()
    if device.type != "cuda":
        fn()
        return None
    rec.enable()
    readings = []
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            common.sync(device)
            readings.append(time.perf_counter_ns())
            t0 = time.perf_counter()
            fn()
            common.sync(device)
            readings.append(time.perf_counter_ns())
            wall = time.perf_counter() - t0
    finally:
        rec.disable()
    records, counters = rec.drain()
    k = prof.profiler.kineto_results
    base = k.trace_start_ns()
    dev, host, runtime, kernels = [], [], {}, []
    for e in k.events():
        s, en = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), s, en))
            kernels.append((s, {e.correlation_id(), e.linked_correlation_id()} - {0}))
        else:
            host.append((e.name(), s, en))
            runtime[e.correlation_id()] = s
    syncs = sorted(end for name, _, end in host if name == tracing.SYNC)
    if not dev or len(syncs) < 2:
        return None
    window = (syncs[0], syncs[-1])
    summary = tracing.reduce(dev, host, window, wall)
    prog = Program({"profiled": records}, counters, rec.clock())
    spans = prog.mapped("profiled", base)
    named = named_idle(dev, host, window, spans)
    summary["idle_gaps"] = named[:10]
    # clock checks: the harness's readings after each of its two
    # synchronisations against the end of the nearest synchronisation in
    # the trace (the profiler adds its own on exit); each
    # top-level span's first device operation (by its launching call)
    # against the span's mapped start
    sync_us = []
    for r in readings:
        at = prog.profiler_us(r, base)
        sync_us.append(min((at - end for end in syncs), key=abs))
    first_op = []
    for s, e, path, r in spans:
        if r["parent"] is not None:
            continue
        starts = [ks for ks, ids in kernels
                  if any(s <= runtime.get(i, -1.0) <= e for i in ids)]
        if starts:
            first_op.append(min(starts) - s)
    idle_s = sum(v for _, v in named)
    named_share = (sum(v for n, v in named if " @ " in n) / idle_s) if idle_s > 0 else None
    return {"summary": summary, "records": records, "counters": counters,
            "idle_by_span": idle_by_span(named), "named_idle_share": named_share,
            "idle_s": idle_s, "gaps": len(named),
            "clock": {"sync_reading_after_sync_us": sync_us,
                      "first_op_after_span_start_us": first_op,
                      "syncs_in_trace_us": [end - prog.profiler_us(readings[0], base)
                                            for end in syncs]},
            "events": len(dev), "runtime_calls": len(host)}


def clock_probe(device: torch.device, rec, n: int = 6) -> Dict:
    """``n`` synchronisations 2 ms apart under the profiler (CUDA activity
    alone), a perf-counter reading right after each: each reading less the
    end of the nearest synchronisation in the trace, once mapped (us), and
    how many synchronisations the trace holds (the profiler adds its own
    on exit)."""
    rec.enable()
    readings = []
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                common.sync(device)
                readings.append(time.perf_counter_ns())
                torch.ones(1, device=device)
                time.sleep(0.002)
    finally:
        rec.disable()
    base = prof.profiler.kineto_results.trace_start_ns()
    ends = sorted((e.end_ns() - base) / 1e3 for e in prof.profiler.kineto_results.events()
                  if e.name() == tracing.SYNC)
    prog = Program({}, {}, rec.clock())
    diffs = []
    for r in readings:
        at = prog.profiler_us(r, base)
        diffs.append(min((at - end for end in ends), key=abs) if ends else None)
    return {"reading_after_sync_us": diffs, "syncs_in_trace": len(ends), "readings": n}

