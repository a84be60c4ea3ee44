"""PointNet++ stage 0's share of its roofline, %: the least time of its
forward over a batch (the larger of the bytes it cannot do without, its
input read once and its output written once, over the memory rate, and the
products it cannot do without, the points' features projected once a
point, over the float32 peak; ``harness/train_rgb.py::sa0_work``) over the
forward's mean synchronised span."""

from harness import train_rgb, work


def read(run):
    ms = run.span_mean_ms("sa0")
    if ms is None or run.peak is None or "sa0" not in train_rgb.SPAN_WORK:
        return None
    return 100.0 * work.least_seconds(*train_rgb.SPAN_WORK["sa0"], run.peak) / (ms / 1e3)
