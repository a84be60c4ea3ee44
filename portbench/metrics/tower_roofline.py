"""The image tower's share of its roofline, %: its counted float32
matrix-product work over one call (``harness/train_rgb.py::tower_ops``)
over the call's mean synchronised span times the card's float32 peak."""

from harness import train_rgb, work


def read(run):
    ms = run.span_mean_ms("image_tower")
    if ms is None or run.peak is None or "image_tower" not in train_rgb.SPAN_WORK:
        return None
    return 100.0 * work.least_seconds(*train_rgb.SPAN_WORK["image_tower"], run.peak) / (ms / 1e3)
