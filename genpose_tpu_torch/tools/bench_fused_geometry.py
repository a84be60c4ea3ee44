"""A/B: the fused FPS + ball-query kernel against the separate kernels.

Counterpart of ``tools/bench_fused_geometry.py``.  At each MSG stage shape of
the ``light`` encoder, and over the whole three-stage geometry chain, it
times the composition the encoder runs (FPS -> gather centers -> one
ball-query launch for both radii) against ``fps_bq_fused`` (FPS and every radius's ball
query in one kernel, then the same gather, which the SharedMLP's relative
coordinates still need).  Times are CUDA events over back-to-back chains,
after a warm-up.

Run on a machine with a card, from the root of the checkout:

    python3 -m genpose_tpu_torch.tools.bench_fused_geometry [--batch 64] [--iters 16]

It prints one JSON line per metric (ms per stage and arm, ms per chain and
arm, the fused arm's win in percent).  ``chain`` also runs on the CPU, where
both arms reach the plain versions; the tests hold the two arms' indices
equal there.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

import torch

from genpose_tpu_torch.ops.pointcloud import (
    ball_query_msg,
    farthest_point_sample,
    fps_bq_fused,
    gather_points,
)

# the three FPS + ball-query MSG stages of ClsMSG 'light' (models/pointnet2.py):
# (tag, N, npoint, radii, nsamples)
STAGES = (
    ("s0", 1024, 512, (0.02, 0.04), (16, 32)),
    ("s1", 512, 256, (0.04, 0.08), (16, 32)),
    ("s2", 256, 128, (0.08, 0.16), (16, 32)),
)


def sep(x: torch.Tensor, M: int, radii, nsamples):
    """The separate kernels, as ``models/pointnet2.py::sa_geometry`` runs
    them: FPS, gather, one ball query for every radius."""
    fi = farthest_point_sample(x, M)
    centers = gather_points(x, fi)
    return fi, centers, ball_query_msg(radii, nsamples, x, centers)


def fused(x: torch.Tensor, M: int, radii, nsamples):
    """The fused kernel, then the gather of the centers the encoder needs."""
    fi, bq = fps_bq_fused(x, M, radii, nsamples)
    return fi, gather_points(x, fi), bq


def chain(pts: torch.Tensor, use_fused: bool) -> List[Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]]:
    """The three stages in sequence, each on the previous stage's centers.
    Returns (fps_idx, ball-query tables) per stage."""
    arm = fused if use_fused else sep
    x, outs = pts, []
    for _, _, M, radii, nsamples in STAGES:
        fi, x, bq = arm(x, M, radii, nsamples)
        outs.append((fi, bq))
    return outs


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, after a warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(pts: torch.Tensor, iters: int) -> Dict[str, float]:
    """ms per stage and arm, per chain and arm, and the fused win in percent.
    The arms alternate (separate, fused), so both see the same card state."""
    if not pts.is_cuda:
        raise ValueError("measure times the CUDA kernels: pass a CUDA tensor")
    out: Dict[str, float] = {}
    for tag, N, M, radii, nsamples in STAGES:
        x = pts[:, :N, :].contiguous()
        out[f"{tag}_separate_ms"] = cuda_ms(lambda: sep(x, M, radii, nsamples), iters)
        out[f"{tag}_fused_ms"] = cuda_ms(lambda: fused(x, M, radii, nsamples), iters)
    out["chain_separate_ms"] = cuda_ms(lambda: chain(pts, False), iters)
    out["chain_fused_ms"] = cuda_ms(lambda: chain(pts, True), iters)
    out["chain_fused_win_pct"] = (out["chain_separate_ms"] - out["chain_fused_ms"]) \
        / out["chain_separate_ms"] * 100.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fused_geometry: CUDA is not available", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    pts = torch.randn(args.batch, 1024, 3, generator=gen, device="cuda") * 0.1
    print(json.dumps({"device": torch.cuda.get_device_name(0), "batch": args.batch}))
    for name, value in measure(pts, args.iters).items():
        unit = "pct" if name.endswith("pct") else "ms"
        print(json.dumps({"metric": name, "value": value, "unit": unit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
