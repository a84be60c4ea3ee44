"""Mean device ms of a ``serve.request`` outside its ``sample`` and
``energy`` spans, in the program slice: the work and the waits outside the
two frozen programs (copies in and out, the geometry, the ranking and
pooling, the host between them)."""

from harness.program import mean, program_of


def read(run):
    prog = program_of(run)
    return None if prog is None else mean(
        prog.per_root_ms("slice", "serve.request", ("sample", "energy")))
