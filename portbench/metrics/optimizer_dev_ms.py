"""Mean device ms of the program's ``optimizer`` span
(``TrainState.apply_gradients``: clip, Adam, EMA) per step, in the program
slice."""

from harness.program import mean, program_of


def read(run):
    prog = program_of(run)
    return None if prog is None else mean(prog.device_ms("slice", "optimizer"))
