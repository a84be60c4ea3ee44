"""Host seconds of every ``frozen.capture`` span in set-up: the frozen
programs' warm-up and their capture into CUDA graphs."""

from harness.program import program_of


def read(run):
    prog = program_of(run)
    spans = [] if prog is None else prog.host_s("setup", "frozen.capture")
    return sum(spans) if spans else None
