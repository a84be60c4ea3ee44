"""Mean synchronised span of ``PoseAgent.sample`` (the frozen Heun program) per request, ms."""


def read(run):
    return run.span_mean_ms("sample")
