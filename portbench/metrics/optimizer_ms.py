"""Mean synchronised span of ``TrainState.apply_gradients`` (clip, Adam, EMA) per step, ms."""


def read(run):
    return run.span_mean_ms("optimizer")
