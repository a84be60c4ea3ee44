"""The training loader's numbers of several checkouts, in turns, on one machine.

    python -m genpose_tpu_torch.tools.loader_ab --tree DIR CHECKOUT [CHECKOUT ...]

Writes ``chip_smoke.py`` phase 15's synthetic NOCS tree (384 CAMERA and 32
Real train scenes at 640x480, seed 0) into ``DIR`` unless it is there.
Then, for each checkout in the order given, a fresh interpreter started in
that checkout runs its own ``chip_smoke.py``'s ``sample_host_split`` (one
training sample's host time by function, medians of 24) and
``loader_modes`` (one train epoch of the thread and of the process loader
at the config's defaults: samples/s, bit-identical batches) on the tree.
Each run prints one JSON line; the last line holds them all.  To compare
two commits, unpack each (``git archive``) and give them as parent,
change, change, parent.  ``loader_modes`` prints the card's name and
power limit (``nvidia-smi``), so run it on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CAMERA_SCENES, REAL_SCENES = 384, 32  # chip_smoke.py's CLI_CAMERA_SCENES, CLI_REAL_SCENES

_RUN = """
import json, sys
import chip_smoke as c
card = c.card_line()
split = c.sample_host_split(sys.argv[1])
rates = c.loader_modes(sys.argv[1], card)[0]
print("LOADER_AB " + json.dumps({"sample_host_ms": split, "loader": rates, "card": card}))
"""


def run_checkout(checkout: Path, tree: str) -> dict:
    """One checkout's numbers, from a fresh interpreter in that checkout."""
    res = subprocess.run([sys.executable, "-c", _RUN, tree], cwd=checkout,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=1800)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("LOADER_AB ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"{checkout}: exit {res.returncode}\n{res.stdout}\n{res.stderr}")
    return json.loads(lines[-1][len("LOADER_AB "):])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="the synthetic NOCS tree (made if missing)")
    parser.add_argument("checkouts", nargs="+", type=Path, help="checkout roots, in run order")
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    if not tree.exists():
        from genpose_tpu_torch.data.synthetic import make_synthetic_nocs_dir

        make_synthetic_nocs_dir(str(tree), n_camera_scenes=CAMERA_SCENES,
                                n_real_scenes=REAL_SCENES, seed=0)
    runs = []
    for checkout in args.checkouts:
        run = {"checkout": str(checkout), **run_checkout(checkout.resolve(), str(tree))}
        runs.append(run)
        print(json.dumps(run), flush=True)
    print(json.dumps({"loader_ab": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
