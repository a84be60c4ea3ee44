"""Mean device ms of the program's ``data.process`` span
(``data/process.py::process_batch``: the batch's copies to the device and
its augmentation) per step, in the program slice."""

from harness.program import mean, program_of


def read(run):
    prog = program_of(run)
    return None if prog is None else mean(prog.device_ms("slice", "data.process"))
