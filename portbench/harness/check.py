"""The numbers that decide ``correct``: what the timed path produced, held
against the reference on the same inputs, weights and draws.

Serving (per checked request, the worst over them):

- ``pose_gap``, the largest of: a hypothesis entry's difference (the
  rotation's two columns, the translation in metres) from the reference's
  hypothesis from the same start; the pooled rotation's shortfall from the
  top of the kept quaternions' moment matrix (Rayleigh quotient, relative,
  and right for any vector of a degenerate top eigenspace); the pooled
  translation's difference from the kept translations' mean;
- ``energy_gap``, the larger of: an energy's difference from the
  reference's energy of the same hypothesis; by how much a hypothesis the
  program kept (its top ``keep`` by its own energies, per channel) lies
  below one it left out, in the reference's energies; over the largest
  reference energy.

Training (the first three steps; every leaf of the reference):

- ``loss_gap``: the largest relative difference of a step's loss;
- ``grad_gap``: the first step's clipped gradient, read from the
  optimizer's first moment; per leaf the gap of the two norms over the
  larger of the reference's norm and the median leaf's norm, the worst leaf;
- ``change_gap`` / ``ema_gap``: the same for the parameters' and the EMA
  shadow's change after three steps, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's;
- ``aug_gap``: the 3D augmentation of the three steps' batches, the
  largest difference of a cloud's coordinate or a pose entry (metres, or
  the rotation's entries) from the reference's augmentation of the same
  raw batch and draws.  The reference steps from the program's augmented
  clouds and poses: float32 rounding in the augmentation moves points
  across a ball query's radius, and the steps would part at the control's
  level.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch

from reference import genpose_ref as ref


def order(energy: torch.Tensor) -> torch.Tensor:
    """Hypotheses by descending energy per channel, ties in index order."""
    return torch.argsort(-energy, dim=1, stable=True)


def serve_numbers(hyp: torch.Tensor, energy: torch.Tensor, pooled_q: torch.Tensor,
                  pooled_t: torch.Tensor, keep: int, hyp_ref: torch.Tensor,
                  energy_ref: torch.Tensor) -> Dict[str, float]:
    """hyp [B, K, 9] and energy [B, K, 2]: the program's, unsorted; pooled
    wxyz [B, 4] and t [B, 3]: the program's; hyp_ref: the reference's from
    the same start; energy_ref: the reference's energies of ``hyp``."""
    scale = float(energy_ref.abs().max())
    o = order(energy)
    slack = 0.0
    for c in range(2):
        e = torch.gather(energy_ref[..., c], 1, o[..., c])
        if keep < e.shape[1]:
            below = (e[:, keep:].amax(1) - e[:, :keep].amin(1)).clamp(min=0)
            slack = max(slack, float(below.max()))
    rot_kept = torch.gather(hyp[..., :6], 1, o[..., 0:1].expand(-1, -1, 6)[:, :keep])
    trans_kept = torch.gather(hyp[..., 6:], 1, o[..., 1:2].expand(-1, -1, 3)[:, :keep])
    A = ref.quaternion_moment(ref.matrix_to_quat(ref.rot6d_to_matrix(rot_kept)))
    top = torch.linalg.eigvalsh(A)[:, -1]
    q = pooled_q / pooled_q.norm(dim=-1, keepdim=True)
    rayleigh = torch.einsum("bi,bij,bj->b", q, A, q)
    return {"pose_gap": max(float((hyp - hyp_ref).abs().max()),
                            float(((top - rayleigh) / top).max()),
                            float((pooled_t - trans_kept.mean(1)).abs().max())),
            "energy_gap": max(float((energy - energy_ref).abs().max()), slack) / scale}


def pool(r, hyp: torch.Tensor, energy: torch.Tensor, keep: int):
    """Reference ``r``'s own pooling: (wxyz [B, 4], t [B, 3]) of the top
    ``keep`` per channel by ``energy``, the moment matrix through ``r.mm``."""
    o = order(energy)
    rot = torch.gather(hyp[..., :6], 1, o[..., 0:1].expand(-1, -1, 6)[:, :keep])
    trans = torch.gather(hyp[..., 6:], 1, o[..., 1:2].expand(-1, -1, 3)[:, :keep])
    quats = ref.matrix_to_quat(ref.rot6d_to_matrix(rot))
    quats = torch.where(quats[..., :1] > 0, 1.0, -1.0) * quats
    A = r.mm(quats.transpose(1, 2), quats) / keep
    q = torch.linalg.eigh(A)[1][..., -1]
    return torch.where(q[..., :1] > 0, 1.0, -1.0) * q, trans.mean(1)


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(n[k] for n in numbers) for k in numbers[0]} if numbers else {}


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              leaves: Optional[List[str]] = None) -> float:
    leaves = list(want) if leaves is None else leaves
    norms = torch.stack([want[k].norm() for k in leaves])
    floor = norms.median()
    return max(float((got[k].norm() - want[k].norm()).abs() / torch.maximum(want[k].norm(), floor))
               for k in leaves)


def aug_gap(got, want) -> float:
    """The largest difference over lists of (clouds, poses)."""
    return max(float((a - b).abs().max()) for g, w in zip(got, want) for a, b in zip(g, w))


def train_numbers(losses: List[float], grads: Dict, params: Dict, shadow: Dict,
                  ref_losses: List[float], ref_grads: Dict, ref_params: Dict,
                  ref_shadow: Dict, w0: Dict) -> Dict[str, float]:
    """The program's first three losses, first clipped gradient, and its
    parameters and shadow after three steps, against the reference's, all
    from the weights ``w0``."""
    gnorm = {k: v.norm() for k, v in ref_grads.items()}
    med = torch.stack(list(gnorm.values())).median()
    moved = [k for k in ref_grads if gnorm[k] >= 1e-3 * med]
    if len(moved) < len(ref_grads):
        print("leaves left out of the changes (reference gradient under 1e-3 of the median "
              f"leaf's): {sorted(set(ref_grads) - set(moved))}", file=sys.stderr, flush=True)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": _leaf_gap(grads, ref_grads),
        "change_gap": _leaf_gap({k: params[k] - w0[k] for k in moved},
                                {k: ref_params[k] - w0[k] for k in moved}),
        "ema_gap": _leaf_gap({k: shadow[k] - w0[k] for k in moved},
                             {k: ref_shadow[k] - w0[k] for k in moved}),
    }
