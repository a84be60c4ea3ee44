"""Spans and counters of the port's layers, on the profiler's clock.

The port's one tracing system.  It is off by default, and then ``span``
returns one shared null context after a single flag test: nothing is
allocated, recorded or synchronised.  Between ``enable()`` and
``disable()`` each ``span(name, device=None, **attrs)`` keeps a record:

- its name, its id, the id of the span open around it on the same thread
  (``parent``), and the id of the outermost one (``root``: one request's
  or one step's spans share it), its attributes;
- its host start and end from ``time.perf_counter_ns()``, taken where the
  layer's work is enqueued, with no synchronisation;
- given a CUDA ``device``, a pair of timing events on that device's current
  stream, so that ``drain()`` gives the span's device milliseconds: from
  when the stream reached the span's first work to when it finished its
  last.  No event is recorded while the current stream is being captured
  into a CUDA graph (a capture cannot hold one); such a span has no device
  time.

Records stay in memory until ``drain()``, which synchronises once and
returns them with a ``snapshot()`` of the counters.  ``spanned(name,
device=...)`` is the decorator form: it tests the flag at each call, and
``device`` is a function of the call's arguments giving the device.

Spans sit at layer boundaries only (a request, its copies, the geometry,
the image tower and the lifting of its features, the sampler, the
energies, a frozen program's replay or capture, the ranking and pooling, a
batch's preparation, a training step, the optimizer): never inside a function a CUDA graph captures, a sampler's
step loop or per-kernel code.

Counters count whether tracing is on or off.  ``count(name)`` keeps the
counters of this module (``frozen.captures``: programs captured into CUDA
graphs; ``score_head.fused`` / ``score_head.plain``: ``PoseScoreNet.score_from``
calls by path, eager or at capture, so a graph's replays add nothing;
``sa_stage.fused`` / ``sa_stage.plain``: the radii of grouped PointNet++ SA
stages by path (``models/pointnet2.py::fused_sa_applies``), counted the same
way;
``image_tower.crops`` / ``feature_lift.points``: crops through the image
tower and points given its features, ``PoseAgent.image_features``);
``snapshot()`` adds, as they stand, the module counters the port
kept before: ``training/frozen.py::dispatches`` and the ``launches`` of
``ops/{fps,ball_query,fps_bq_fused}_cuda.py``.

Clocks: ``enable()`` reads one (``time.time_ns()``, ``perf_counter_ns()``)
pair back to back (``clock()``), which puts a host time ``t`` on the wall
clock (``t - perf + wall``); ``torch.profiler`` shares that clock: its
events' times are microseconds after
``prof.profiler.kineto_results.trace_start_ns()``.

Usage:
    from genpose_tpu_torch.utils import trace
    trace.enable()
    with trace.span("serve.request", device=dev, rows=n):
        ...
    records, counters = trace.drain()
    trace.disable()
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

_on = False
_clock: Tuple[int, int] = (0, 0)
_records: List["_Span"] = []
_ids = itertools.count(1)
_local = threading.local()
_counts: Dict[str, int] = {"frozen.captures": 0, "score_head.fused": 0, "score_head.plain": 0,
                           "sa_stage.fused": 0, "sa_stage.plain": 0, "image_tower.crops": 0,
                           "feature_lift.points": 0}


class _Null:
    """The context every ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One span while it is open, and its record once it is closed."""

    __slots__ = ("name", "attrs", "device", "id", "parent", "root", "start_ns", "end_ns",
                 "events")

    def __init__(self, name: str, device, attrs: Dict):
        self.name, self.attrs, self.events = name, attrs, None
        self.device = device if getattr(device, "type", None) == "cuda" else None

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if self.device is not None and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            self.events = (start, None)
        return self

    def __exit__(self, *exc):
        if self.events is not None and not torch.cuda.is_current_stream_capturing():
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.events = (self.events[0], end)
        self.end_ns = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        _records.append(self)
        return False

    def record(self) -> Dict:
        """The closed span as a plain dict (its events synchronised)."""
        ms = None
        if self.events is not None and self.events[1] is not None:
            ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "attrs": self.attrs, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": ms}


def span(name: str, device=None, **attrs):
    """A context that records the span ``name`` while tracing is on (with
    device time on a CUDA ``device``), and the shared null context while it
    is off."""
    if not _on:
        return _NULL
    return _Span(name, device, attrs)


def spanned(name: str, device: Optional[Callable] = None):
    """Decorator: each call runs inside ``span(name, device(*args,
    **kwargs))`` while tracing is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, device(*args, **kwargs) if device is not None else None, {}):
                return fn(*args, **kwargs)

        return inner

    return wrap


def enable() -> None:
    """Turn tracing on and read the clock pair."""
    global _on, _clock
    best = None
    for _ in range(5):  # the pair whose wall readings lie closest around it
        w0 = time.time_ns()
        m = time.perf_counter_ns()
        w1 = time.time_ns()
        if best is None or w1 - w0 < best[0]:
            best = (w1 - w0, (w0 + w1) // 2, m)
    _clock = best[1:]
    _on = True


def disable() -> None:
    global _on
    _on = False


def clock() -> Tuple[int, int]:
    """The (wall ns, perf-counter ns) pair read at the last ``enable()``."""
    return _clock


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def snapshot() -> Dict[str, int]:
    """Every counter as it stands."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_bq_fused_cuda, fps_cuda
    from genpose_tpu_torch.training import frozen

    return {"frozen.dispatches": frozen.dispatches, "fps.launches": fps_cuda.launches,
            "ball_query.launches": ball_query_cuda.launches,
            "fps_bq_fused.launches": fps_bq_fused_cuda.launches, **_counts}


def drain() -> Tuple[List[Dict], Dict[str, int]]:
    """The spans closed since the last drain, in the order they opened,
    with their device times (one synchronisation of each device that has
    any), and the counters."""
    global _records
    spans, _records = _records, []
    for dev in {s.device for s in spans if s.events is not None}:
        torch.cuda.synchronize(dev)
    return [s.record() for s in sorted(spans, key=lambda s: s.id)], snapshot()
