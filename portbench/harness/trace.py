"""The device trace of a slice of units, taken with ``torch.profiler`` after
the measured window with the CUDA activity alone (kernels, copies and the
CUDA runtime calls; no tracing of PyTorch's host operations, which would
slow the host), reduced to what the metrics read: the seconds in which an
operation ran on the device (the union of kernel, copy and set
intervals), the traced window, each kernel's device time, and the idle
gaps named by the runtime call the host was in.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from harness import common

SYNC = "cudaDeviceSynchronize"


def profile(fn: Callable[[], None], device: torch.device) -> Optional[Dict]:
    """Run ``fn`` under the profiler between two synchronisations, whose
    ends bound the traced window; None when the trace holds no device
    operation."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        common.sync(device)
        t0 = time.perf_counter()
        fn()
        common.sync(device)
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    syncs = sorted(end for name, _, end in host if name == SYNC)
    if not dev or len(syncs) < 2:
        return None
    out = reduce(dev, host, (syncs[0], syncs[-1]), wall)
    print(f"profiled {wall:.3f} s, {len(dev)} device operations, {len(host)} runtime calls; "
          f"read in {time.perf_counter() - t1:.1f} s", file=sys.stderr, flush=True)
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(dev, host, window, wall: float) -> Dict:
    """Times in microseconds on the profiler's clock -> seconds."""
    w0, w1 = window
    busy = union([(max(s, w0), min(e, w1)) for _, s, e in dev if e > w0 and s < w1])
    busy_s = sum(e - s for s, e in busy) / 1e6
    per_kernel: Dict[str, float] = {}
    for name, s, e in dev:
        per_kernel[name] = per_kernel.get(name, 0.0) + (e - s) / 1e6
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = [(what_the_host_did(host, (s + e) / 2), (e - s) / 1e6) for s, e in gaps]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6, "wall_s": wall,
            "kernels": per_kernel, "idle_gaps": named}


def what_the_host_did(host, at: float) -> str:
    """The outermost and innermost runtime calls around time ``at``
    (``host``: in none, the host was in Python or PyTorch)."""
    around = sorted((e - s, name) for name, s, e in host if s <= at <= e)
    if not around:
        return "host"
    inner, outer = around[0][1], around[-1][1]
    return outer if inner == outer else f"{outer} > {inner}"


def top_ops(summary: Dict, n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:n]]


def stage_seconds(summary: Dict, patterns: List[str]) -> float:
    """Device seconds of the kernels whose names match any pattern."""
    rx = [re.compile(p) for p in patterns]
    return sum(v for k, v in summary["kernels"].items() if any(r.search(k) for r in rx))
