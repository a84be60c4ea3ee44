"""One run of a cell with the program's own spans and counters
(``genpose_tpu_torch/utils/trace.py``), read as the per-layer metrics that
read inside the program read them, beside the metrics the benchmark reads
today.  Needs a CUDA card.

    python3 portbench/tools/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> [--cost] [--out <dir>]

The run, in order:

- set-up, with the recorder on (the frozen programs' capture, the warm
  units one by one);
- the measured window, with the recorder off, as ``harness/cellrun.py``
  runs it (the rate);
- with ``--cost``, a second window of the same length with the recorder on
  (the recorder's cost, and device times over the whole window);
- the synchronised span slice of ``span_units`` units (``sample_ms``,
  ``optimizer_ms``, as ``--trace 1`` reads them);
- the program slice: ``span_units`` units with the recorder on, neither
  synchronised nor profiled (the device times);
- the profiled slice of ``profile_units`` units, with the recorder on:
  every idle gap named ``<runtime call> @ <span path>``, the idle seconds
  by span, and the clock checks.

Prints one JSON line and writes it to ``<out>/<workload>.<seed>.json``
(default ``chiprun_out/program_trace``).  Every metric's reader is
``metrics/<stem>.py``, found by name as the harness finds it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECKOUT = ROOT.parent
CACHE = CHECKOUT / "build" / "portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(CHECKOUT))

# the per-layer metrics read inside the program, by the traffic's kind
PROGRAM_METRICS = {
    "serve": ["sample_dev_ms.eval", "energy_dev_ms.eval", "eager_ms.eval", "capture_s.eval"],
    "train": ["optimizer_dev_ms.train", "data_ms.train"],
}


def roots(prog, part: str, t_start_ns: int):
    """Each top-level span of a part: (name, seconds after the process
    started, host ms, device ms, {child name: device ms summed})."""
    recs = prog.records(part)
    out = []
    for r in recs:
        if r["parent"] is not None:
            continue
        kids = {}
        for x in recs:
            if x["root"] == r["id"] and x["id"] != r["id"] and x["device_ms"] is not None:
                kids[x["name"]] = kids.get(x["name"], 0.0) + x["device_ms"]
        out.append([r["name"], (r["start_ns"] - t_start_ns) / 1e9,
                    (r["end_ns"] - r["start_ns"]) / 1e6, r["device_ms"], kids])
    return out


def window(d, first: int, seconds: float, device):
    """Units back to back from ``first`` until ``seconds`` have passed, the
    device synchronised on both sides: (units, seconds, its start)."""
    from harness import common

    units = 0
    common.sync(device)
    t0 = time.perf_counter()
    while True:
        d.unit(first + units)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    return units, time.perf_counter() - t0, t0


def run(workload: str, seed: int, seconds: float, cost: bool, device, t_start: float,
        traffic_overrides=None) -> dict:
    """The run the module's docstring sets out; returns its line."""
    import importlib

    from harness import cellrun, common, program, work

    rec = program.recorder()
    if rec is None:
        raise RuntimeError("the program has no recorder (genpose_tpu_torch/utils/trace.py)")
    t_start_ns = time.perf_counter_ns() - int((time.perf_counter() - t_start) * 1e9)
    cell, config, traffic = common.cell(workload)
    traffic = {**traffic, **(traffic_overrides or {})}
    kind = traffic["kind"]
    spans = common.Spans(device)
    d = importlib.import_module(f"harness.{kind}").Driver(config, traffic, device, seed, spans)

    rec.drain()
    rec.enable()
    d.setup()
    for i in range(traffic.get("warm_units", 1)):
        d.warm(i)
    d.start()
    rec.disable()
    setup_records, _ = rec.drain()
    clock = rec.clock()

    units, window_s, t0 = window(d, 0, seconds, device)
    out = {"workload": workload, "seed": seed, "setup_s": t0 - t_start, "units": units,
           "window_s": window_s, "rate_off": units / window_s}
    at = units
    window_records = []
    if cost:
        rec.enable()
        on_units, on_s, _ = window(d, at, seconds, device)
        rec.disable()
        window_records, _ = rec.drain()
        at += on_units
        out.update(units_on=on_units, window_on_s=on_s, rate_on=on_units / on_s,
                   cost=1.0 - (on_units / on_s) / (units / window_s))

    spans.on = True
    for i in range(at, at + traffic["span_units"]):
        d.unit(i)
    spans.on = False
    at += traffic["span_units"]

    rec.drain()
    rec.enable()
    for i in range(at, at + traffic["span_units"]):
        d.unit(i)
    rec.disable()
    slice_records, counters = rec.drain()
    at += traffic["span_units"]

    prof = program.profile(lambda: d.profiled(at, traffic["profile_units"]), device, rec)
    spans.unwrap()
    if device.type == "cuda":
        out["clock_probe"] = program.clock_probe(device, rec)

    prog = program.Program({"setup": setup_records, "slice": slice_records,
                            "profiled": prof["records"] if prof else []}, counters, clock)
    peak = common.peaks(device)
    least = None
    if peak is not None:
        ops = nbytes = 0.0
        for xyz in d.geometry_clouds():
            o, b = work.geometry_work(config["encoder_stages"], xyz)
            ops, nbytes = ops + o, nbytes + b
        least = work.least_seconds(ops, nbytes, peak)
    view = cellrun.RunView(spans.ms, units, window_s, d.ops_per_unit(), peak,
                           prof["summary"] if prof else None, least, cellrun.kernel_patterns())
    view.program = prog
    e2e = list(d.end_to_end(units, window_s, [None]))
    names = cellrun.cell_metrics(workload, e2e) + PROGRAM_METRICS[kind]
    out["metrics"] = {n: finite(cellrun.metric_reader(n)(view)) for n in names}
    if window_records:
        view.program = program.Program({"slice": window_records}, counters, clock)
        out["metrics_window_on"] = {n: finite(cellrun.metric_reader(n)(view))
                                    for n in PROGRAM_METRICS[kind] if n != "capture_s.eval"}
    out["setup_roots"] = roots(prog, "setup", t_start_ns)
    out["slice_roots"] = roots(prog, "slice", t_start_ns)
    out["captures"] = [[r["attrs"], (r["end_ns"] - r["start_ns"]) / 1e9]
                       for r in prog.records("setup", "frozen.capture")]
    out["counters"] = counters
    if prof:
        out["profiled"] = {k: prof[k] for k in ("idle_by_span", "named_idle_share", "idle_s",
                                                "gaps", "clock", "events", "runtime_calls")}
        out["profiled"].update({k: prof["summary"][k]
                                for k in ("busy_s", "window_s", "idle_gaps")})
    return out


def finite(v):
    return v if v is not None and math.isfinite(v) else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--out", default=str(CHECKOUT / "chiprun_out" / "program_trace"))
    args = p.parse_args(argv)

    import torch

    from harness import common

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = {"card": common.card_line(),
           **run(args.workload, args.seed, args.seconds, args.cost, torch.device("cuda", 0),
                 T_START)}
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"forbidden modules were loaded: {loaded}", file=sys.stderr)
        return 3
    line = json.dumps(out)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.workload}.{args.seed}.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
