"""Medians and spreads of runs written by ``tools/sets.sh``: for each set of
each directory, every metric's median and its spread (the distance between
the first and third quartile over the median, as
``statistics.quantiles(values, n=4)`` gives them), and the largest reading
of each compared number.

    python3 portbench/tools/spread.py <out dir>...
"""

import glob
import json
import statistics
import sys


def spread(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(dirs):
    for d in dirs:
        sets = {}
        for f in sorted(glob.glob(f"{d}/*.out")):
            _, st, seed, _ = f.rsplit(".", 3)
            lines = open(f).read().strip().splitlines()
            if lines:
                sets.setdefault(st, []).append(json.loads(lines[-1]))
        for st, runs in sorted(sets.items()):
            print(f"{d} set {st}: {len(runs)} runs, correct {all(r['correct'] for r in runs)}")
            metrics, checks = {}, {}
            for r in runs:
                for k, v in r["metrics"].items():
                    metrics.setdefault(k, []).append(v["value"])
                for k, v in r["checks"].items():
                    checks.setdefault(k, []).append(v["value"])
            for k, v in metrics.items():
                print(f"  {k:22s} median {statistics.median(v):.4f} spread {100 * spread(v):.3f}% "
                      + " ".join(f"{x:.3f}" for x in v))
            print("  largest compared numbers:", {k: f"{max(v):.3g}" for k, v in checks.items()})


if __name__ == "__main__":
    main(sys.argv[1:])
