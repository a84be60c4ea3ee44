"""Mean device ms of the program's ``sample`` span (``PoseAgent.sample``:
the draws, the copies into the frozen program and its replay) per
``serve.request``, in the program slice."""

from harness.program import mean, program_of


def read(run):
    prog = program_of(run)
    return None if prog is None else mean(prog.root_sum_ms("slice", "serve.request", "sample"))
