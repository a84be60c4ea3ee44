"""Share of the profiled slice in which no operation ran on the device, %."""


def read(run):
    return run.idle_pct()
