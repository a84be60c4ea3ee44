"""The work a cell asks for, counted from the configuration's widths and the
traffic's shapes, never from what an implementation runs: the
matrix-product operations of a step (``mfu``) and the operations and bytes
of the point-cloud geometry (the geometry roofline).  The tests hold the
matrix-product counts equal to ``FlopCounterMode`` over the reference at
small shapes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from reference import genpose_ref as ref

T, P, KH = ref.T_DIM, ref.POSE_FEAT, 3 * ref.TAIL_HIDDEN


def _stage_shapes(stages: Dict, n_points: int) -> List[Tuple[int, int, List[int]]]:
    """(groups, samples per group, widths) of every SharedMLP per cloud."""
    out, n_in = [], n_points
    widths = {(k, i): w for k, i, w in ref.encoder_widths(stages)}
    for k, npoint in enumerate(stages["NPOINTS"]):
        for i, ns in enumerate(stages["NSAMPLE"][k]):
            groups, samples = (1, n_in) if npoint is None else (npoint, ns)
            out.append((groups, samples, widths[(k, i)]))
        n_in = npoint or 1
    return out


def encoder_ops(stages: Dict, n_points: int, backward: bool = False) -> int:
    """Matrix-product operations of one cloud through the encoder; with
    ``backward`` those of its backward pass too (the weight gradients, and
    the input gradients of every layer but the first of stage 0, whose
    input is the grouped coordinates)."""
    total = 0
    for (groups, samples, w), first_stage in zip(
            _stage_shapes(stages, n_points),
            [k == 0 for k, _, _ in ref.encoder_widths(stages)]):
        for j in range(len(w) - 1):
            fwd = 2 * groups * samples * w[j] * w[j + 1]
            total += fwd
            if backward:
                total += fwd if (first_stage and j == 0) else 2 * fwd
    return total


def head_ops(rows: int, t_rows: int, backward: bool = False) -> int:
    """One head evaluation (trunk and tails) over ``rows`` poses whose time
    embedding is computed for ``t_rows`` rows (1 when the step shares its
    time); with ``backward``, the score training's backward pass too (no
    input gradients for the time embedding and the pose's first layer)."""
    t_part = 2 * t_rows * (T * T + T * KH)
    pose_0 = 2 * rows * ref.POSE_DIM * P
    rest = 2 * rows * (P * P + P * KH + KH * 3)
    if not backward:
        return t_part + pose_0 + rest
    # t_dense and pose_dense_0: weight gradients only; the rest both
    return 3 * (t_part + pose_0 + rest) - 2 * t_rows * T * T - pose_0


def projection_ops(clouds: int, backward: bool = False) -> int:
    fwd = 2 * clouds * ref.FEAT_DIM * KH
    return 3 * fwd if backward else fwd


def serve_ops(stages: Dict, clouds: int, K: int, n_points: int, steps: int) -> int:
    """A request: both encoders and projections, 2 x steps - 1 score
    evaluations of the Heun chain at a shared time, one energy pass."""
    evals = 2 * steps - 1
    rows = clouds * K
    return (2 * clouds * encoder_ops(stages, n_points) + 2 * projection_ops(clouds)
            + evals * head_ops(rows, 1) + head_ops(rows, rows))


def dsm_forward_ops(stages: Dict, batch: int, repeat: int, n_points: int) -> int:
    """The DSM loss's forward alone (the trainer's monitoring loss under
    the EMA weights): the encoder, the projection and ``repeat`` draws
    through the head."""
    rows = batch * repeat
    return (batch * encoder_ops(stages, n_points) + projection_ops(batch)
            + head_ops(rows, rows))


def train_ops(stages: Dict, batch: int, repeat: int, n_points: int) -> int:
    """A score step: the encoder, the projection and ``repeat`` DSM draws
    through the head, forward and backward."""
    rows = batch * repeat
    return (batch * encoder_ops(stages, n_points, backward=True)
            + projection_ops(batch, backward=True) + head_ops(rows, rows, backward=True))


# ---------------------------------------------------------------------------
# geometry: farthest point sampling and ball query
# ---------------------------------------------------------------------------

def geometry_work(stages: Dict, xyz: torch.Tensor) -> Tuple[float, float]:
    """(operations, bytes) the geometry of clouds [B, N, 3] needs, counted
    as the kernels' bounds are: FPS 10 operations a point-round (3 sub, 3
    mul, 2 add, a min and a compare), its input and output once; the ball
    query 8 operations a distance for each (centre, point) pair up to the
    later of a centre's row stops (a row stops at its nsample-th hit), one
    compare per pair and radius up to that radius's stop, its inputs and
    output once.  The stops depend on the data, so they are found with the
    reference's geometry."""
    ops = nbytes = 0.0
    B = xyz.shape[0]
    for npoint, radii, nsamples in zip(stages["NPOINTS"], stages["RADIUS"], stages["NSAMPLE"]):
        if npoint is None:
            break
        n = xyz.shape[1]
        ops += B * (npoint - 1) * n * 10
        nbytes += B * n * 12 + B * npoint * 4
        centers = ref.gather(xyz, ref.fps(xyz, npoint))
        d2 = ref.sq_dist(centers[:, :, None, :], xyz[:, None, :, :])
        stops = []
        for radius, ns in zip(radii, nsamples):
            r2 = float(torch.tensor(float(radius) * float(radius), dtype=torch.float32))
            hits = torch.cumsum((d2 < r2).to(torch.int32), dim=-1)
            # pairs up to the nsample-th hit, or every point where fewer hit
            stop = torch.where(hits[..., -1] >= ns, (hits < ns).sum(-1) + 1,
                               torch.full_like(hits[..., -1], n))
            stops.append(stop)
            ops += float(stop.sum())
        ops += 8 * float(torch.stack(stops).amax(0).sum())
        nbytes += B * n * 12 + B * npoint * 12 + B * npoint * sum(nsamples) * 4
        xyz = centers
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 peak."""
    return max(ops / peak["float32_ops_per_s"], nbytes / peak["bytes_per_s"])
