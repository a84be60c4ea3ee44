"""The control of ``correct``, and the faults a cell can have, read at a
cell's own sizes on the inputs a run makes.

The control is the reference in the program's place, computed in TF32
(the operands of every matrix product rounded to 10 mantissa bits), the
nearest precision below the configurations' float32, against the float32
reference: its numbers are the upper readings of the limits in
``cells/*.json``.  The faults are the float32 reference in the program's
place with the fault planted.  Each traffic kind's ``control`` in
``harness/<kind>.py`` says which faults it reads; a training step that
leaves the state unchanged reads 1 on ``change_gap`` and ``ema_gap`` by
their definition and needs no run.

    python3 portbench/tools/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed.  Needs a CUDA card (``--device cpu`` runs
it on the CPU; the tests call ``control`` there at test sizes).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import common  # noqa: E402


def control(workload: str, seed: int, device, overrides=None, n=None):
    cell, config, traffic = common.cell(workload)
    traffic = {**traffic, **(overrides or {})}
    n = n or traffic.get("check_units", 1)
    kind = importlib.import_module(f"harness.{traffic['kind']}")
    return kind.control(config, traffic, device, seed, n)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=None, help="requests per seed")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    if device.type == "cuda":
        print(f"card: {common.card_line()}", flush=True)
    for seed in args.seeds:
        out = control(args.workload, seed, device, n=args.units)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
