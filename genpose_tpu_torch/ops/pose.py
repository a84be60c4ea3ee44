"""Batched pose / rotation math in PyTorch (counterpart of ``genpose_tpu/ops/pose.py``).

Pose dims, quaternion <-> matrix, the reference's *transposed* 6D
convention (``utils/misc.py:136``: the 6D vector holds the first two
**columns** of R), the pytorch3d 'ZYX' Euler angles (``utils/misc.py:142-144``;
``euler_xyz`` holds the angles, ``euler_xyz_sx_cx`` their sines then
cosines), rotation re-projection,
(R, t) inversion, pose vector <-> (R, t) <-> 4x4, and the 4x4
eigen-average of quaternions
(``utils/misc.py:227-249``), and the geodesic rotation error
(``utils/metrics.py:12-33``).  All functions are
batched over leading axes and keep the JAX package's operation order.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def get_pose_dim(pose_mode: str) -> int:
    """Pose vector length per representation (reference ``genpose_utils.py:8-20``)."""
    if pose_mode in ("quat_wxyz", "quat_xyzw"):
        return 7
    if pose_mode == "euler_xyz":
        return 6
    if pose_mode in ("euler_xyz_sx_cx", "rot_matrix"):
        return 9
    raise NotImplementedError(f"pose mode {pose_mode} is not supported")


def quat_wxyz_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix.  q: [..., 4] -> [..., 3, 3]."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def matrix_to_quat_wxyz(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), branchless best-diagonal.

    m: [..., 3, 3] -> [..., 4].  Matches pytorch3d's ``matrix_to_quaternion``
    including its behaviour on non-orthonormal input (no normalisation).
    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    q_abs_sq = torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1)
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))

    cand_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    cands = cands / (2.0 * torch.clamp(q_abs[..., None], min=0.1))

    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return torch.gather(cands, -2, idx)[..., 0, :]


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D rep -> rotation matrix with the reference's *column* convention.

    ``d6[:3]`` is (up to Gram-Schmidt) the first column of R and ``d6[3:6]``
    the second.  d6: [..., 6] -> [..., 3, 3].
    """
    a1, a2 = d6[..., :3], d6[..., 3:6]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=_EPS)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True), min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D rep (first two columns); inverse of rot6d_to_matrix."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def _axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        rows = [(one, zero, zero), (zero, c, -s), (zero, s, c)]
    elif axis == "Y":
        rows = [(c, zero, s), (zero, one, zero), (-s, zero, c)]
    else:  # Z
        rows = [(c, -s, zero), (s, c, zero), (zero, zero, one)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_zyx_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """pytorch3d ``euler_angles_to_matrix(angles, 'ZYX')``: Rz(a0) Ry(a1) Rx(a2).
    angles [..., 3] -> [..., 3, 3]; float32 matmuls (TF32 is off)."""
    rz = _axis_rot("Z", angles[..., 0])
    ry = _axis_rot("Y", angles[..., 1])
    rx = _axis_rot("X", angles[..., 2])
    return torch.matmul(rz, torch.matmul(ry, rx))


def get_rot_matrix(batch_pose: torch.Tensor, pose_mode: str = "quat_wxyz") -> torch.Tensor:
    """Rotation part of a pose vector -> [..., 3, 3] (reference ``misc.py:114-148``)."""
    if pose_mode == "quat_wxyz":
        return quat_wxyz_to_matrix(batch_pose)
    if pose_mode == "quat_xyzw":
        return quat_wxyz_to_matrix(batch_pose[..., [3, 0, 1, 2]])
    if pose_mode == "rot_matrix":
        return rot6d_to_matrix(batch_pose)
    if pose_mode == "euler_xyz_sx_cx":
        return euler_zyx_to_matrix(torch.atan2(batch_pose[..., :3], batch_pose[..., 3:6]))
    if pose_mode == "euler_xyz":
        return euler_zyx_to_matrix(batch_pose)
    raise NotImplementedError(f"rotation mode {pose_mode} is not supported")


def normalize_rotation(rotation: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """Project the rotation block back to the manifold (reference ``misc.py:259-276``)."""
    if pose_mode in ("quat_wxyz", "quat_xyzw"):
        return rotation / torch.clamp(
            torch.linalg.norm(rotation, dim=-1, keepdim=True), min=_EPS)
    if pose_mode == "rot_matrix":
        return matrix_to_rot6d(rot6d_to_matrix(rotation))
    if pose_mode == "euler_xyz_sx_cx":
        theta = torch.atan2(rotation[..., :3], rotation[..., 3:6])
        return torch.cat([torch.sin(theta), torch.cos(theta)], dim=-1)
    if pose_mode == "euler_xyz":
        return rotation
    raise NotImplementedError(f"rotation mode {pose_mode} is not supported")


def inverse_RT(rot: torch.Tensor, trans: torch.Tensor):
    """Invert (R, t): returns (R^T, -R^T t) (reference ``misc.py:192-204``)."""
    inv_rot = rot.transpose(-1, -2)
    return inv_rot, -torch.einsum("...ij,...j->...i", inv_rot, trans)


def pose_to_rt(pose: torch.Tensor, pose_mode: str):
    """Split a pose vector into (R [..., 3, 3], t [..., 3])."""
    idx = get_pose_dim(pose_mode) - 3
    return get_rot_matrix(pose[..., :idx], pose_mode), pose[..., idx:]


def transform_batch_pts(batch_pts: torch.Tensor, batch_pose: torch.Tensor,
                        pose_mode: str = "quat_wxyz", inverse_pose: bool = False) -> torch.Tensor:
    """The xyz channels of clouds [B, N, C>=3] moved by poses [B, pose_dim]
    (R x + t, or the inverse pose's with ``inverse_pose``); the other
    channels as they are (reference ``misc.py:158-189``)."""
    rot, loc = pose_to_rt(batch_pose, pose_mode)
    if inverse_pose:
        rot, loc = inverse_RT(rot, loc)
    new_xyz = torch.einsum("bij,bnj->bni", rot, batch_pts[..., :3]) + loc[:, None, :]
    return torch.cat([new_xyz, batch_pts[..., 3:]], dim=-1)


def rt_to_matrix4(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(R, t) -> homogeneous [..., 4, 4]."""
    m = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = trans
    m[..., 3, 3] = 1.0
    return m


def average_quaternion_batch(Q: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted average of quaternions via the 4x4 outer-product eigenproblem.

    Q: [B, K, 4] (wxyz); weights: [B, K] or None (uniform).  Returns [B, 4]
    with w >= 0 (reference ``misc.py:227-249``).  The eigenvector's sign is
    fixed by w, so a result with w == 0 is defined only up to sign.
    """
    B, K, _ = Q.shape
    if weights is None:
        weights = torch.full((B, K), 1.0 / K, dtype=Q.dtype, device=Q.device)
    weight_sum = torch.sum(weights, dim=-1)

    oriented = torch.where(Q[..., :1] > 0, 1.0, -1.0) * Q
    A = torch.einsum("bki,bkj,bk->bij", oriented, oriented, weights)
    A = A / weight_sum[:, None, None]

    # symmetric 4x4 eigh, eigenvalues ascending -> last eigenvector
    _, vecs = torch.linalg.eigh(A)
    q_avg = vecs[..., :, -1]
    return torch.where(q_avg[..., :1] > 0, 1.0, -1.0) * q_avg


def rot_diff_rad(rot1: torch.Tensor, rot2: torch.Tensor, chosen_axis: str | None = None,
                 flip_axis: bool = False) -> torch.Tensor:
    """Geodesic angle between rotations [..., 3, 3], optionally about one
    symmetry axis (reference ``metrics.py:12-22``): ``chosen_axis`` in
    {'x', 'y', 'z'} compares that **column** of R; ``flip_axis`` takes the
    smaller of the angle and pi minus it."""
    if chosen_axis is not None:
        axis = {"x": 0, "y": 1, "z": 2}[chosen_axis]
        diff = torch.sum(rot1[..., axis] * rot2[..., axis], dim=-1)
        rad = torch.arccos(torch.clamp(diff, -1.0, 1.0))
        if flip_axis:
            rad = torch.minimum(rad, math.pi - rad)
        return rad
    mat_diff = rot1 @ rot2.transpose(-1, -2)
    trace = mat_diff[..., 0, 0] + mat_diff[..., 1, 1] + mat_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))


def rot_diff_degree(rot1: torch.Tensor, rot2: torch.Tensor, chosen_axis: str | None = None,
                    flip_axis: bool = False) -> torch.Tensor:
    """``rot_diff_rad`` in degrees."""
    return rot_diff_rad(rot1, rot2, chosen_axis, flip_axis) / math.pi * 180.0
