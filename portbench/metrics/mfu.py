"""The whole unit's share of the card's float32 peak, %: the matrix
products the measured window's units need, counted from the widths and
shapes, over the window's seconds times the peak."""


def read(run):
    return run.mfu_pct()
