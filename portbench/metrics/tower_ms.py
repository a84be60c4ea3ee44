"""Synchronised span of the port's frozen image tower
(``models/vit.py::ImageTower``) per training step, ms: the spans' sum over
the span slice's steps."""


def read(run):
    calls, steps = run.spans.get("image_tower"), run.spans.get("step")
    if not calls or not steps:
        return None
    return sum(calls) / len(steps)
