"""The geometry stage's share of its roofline, %: the least time of the
profiled units' farthest point sampling and ball query (counted from
their clouds and the configuration's stages) over the device time of the
kernels that ``kernels/*.json`` give the ``geometry`` stage."""


def read(run):
    return run.roofline_pct("geometry")
