"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``genpose_tpu_torch``.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the window under spans, then a
profiled slice).  The last line of standard output is the result as JSON;
the compared numbers are the last lines of standard error.  Exits non-zero
and prints no result without a CUDA card, when the program is missing, or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# every cache a run may fill lives at a fixed place inside the checkout
CACHE = CHECKOUT / "build" / "portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import common

    common.cell(args.workload)           # the cell's files exist
    chips = next(w["chips"] for w in common.benchmark()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import genpose_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    from harness.cellrun import run_cell

    print(f"card: {common.card_line()}", file=sys.stderr, flush=True)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"forbidden modules were loaded: {loaded}", file=sys.stderr)
        return 3
    common.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
