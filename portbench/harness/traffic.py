"""The one generator that every traffic file's parameters drive: object
clouds, training batches and the draws of their steps, each a function of
the run's seed and a unit's index alone, made on the device in a few
calls."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from harness import common


def rotations(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n uniform random rotations [n, 3, 3] from unit quaternions."""
    q = torch.randn(n, 4, generator=gen, device=device)
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def ellipsoid_axes(gen: torch.Generator, n: int, cloud: Dict, device) -> torch.Tensor:
    lo, hi = cloud["axes_m"]
    return torch.rand(n, 1, 3, generator=gen, device=device) * (hi - lo) + lo


def surface_points(gen: torch.Generator, axes: torch.Tensor, n_points: int,
                   cloud: Dict) -> torch.Tensor:
    """Points on ellipsoid surfaces [n, n_points, 3] (object frame) with
    Gaussian sensor noise."""
    n = axes.shape[0]
    d = torch.randn(n, n_points, 3, generator=gen, device=axes.device)
    pts = d / d.norm(dim=-1, keepdim=True) * axes
    return pts + torch.randn(n, n_points, 3, generator=gen, device=axes.device) * cloud["noise_m"]


def placements(gen: torch.Generator, n: int, cloud: Dict, device) -> torch.Tensor:
    """Object centres [n, 3] in front of the camera."""
    xy, (z0, z1) = cloud["center_xy_m"], cloud["center_z_m"]
    u = torch.rand(n, 3, generator=gen, device=device)
    return torch.stack([(u[:, 0] * 2 - 1) * xy, (u[:, 1] * 2 - 1) * xy,
                        z0 + u[:, 2] * (z1 - z0)], dim=-1)


def request_clouds(traffic: Dict, seed: int, i: int, device) -> torch.Tensor:
    """Request i's clouds [batch, points, 3], camera frame: object-sized
    ellipsoids (3-15 cm semi-axes, 2 mm noise), posed at random."""
    gen = common.generator(device, common.seed_of(seed, 1, i))
    n, cloud = traffic["batch"], traffic["cloud"]
    pts = surface_points(gen, ellipsoid_axes(gen, n, cloud, device), traffic["points"], cloud)
    R = rotations(gen, n, device)
    return pts @ R.transpose(1, 2) + placements(gen, n, cloud, device)[:, None, :]


def euler_rotations(deg: torch.Tensor) -> torch.Tensor:
    """Rz(z) @ Ry(y) @ Rx(x) [n, 3, 3] from angles (x, y, z) [n, 3] in degrees."""
    c, s = torch.cos(torch.deg2rad(deg)).unbind(-1), torch.sin(torch.deg2rad(deg)).unbind(-1)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat((one, zero, zero), (zero, c[0], -s[0]), (zero, s[0], c[0]))
    ry = mat((c[1], zero, s[1]), (zero, one, zero), (-s[1], zero, c[1]))
    rz = mat((c[2], -s[2], zero), (s[2], c[2], zero), (zero, zero, one))
    return rz @ ry @ rx


def train_batches(traffic: Dict, seed: int, device) -> list:
    """The training pool: ``pool`` raw batches as the NOCS loader hands them
    over (host arrays).  Each object is a random box (diagonal 1, its points
    on the faces, which are also its model points) of a category drawn from
    ``categories``, scaled to ``box.scale_m`` and posed at random in front
    of the camera, with the category's mean shape, symmetry and FS-Net
    scale residual, and the loader's per-object augmentation draws
    (``loader_draws``: box scales, a shift in metres, Euler angles in
    degrees)."""
    gen = common.generator(device, common.seed_of(seed, 6))
    B, n, box, ld = traffic["batch"], traffic["points"], traffic["box"], traffic["loader_draws"]
    cats = traffic["categories"]
    mean_shape = torch.tensor([c["mean_shape_mm"] for c in cats], device=device) / 1000.0
    sym = torch.tensor([c["sym"] for c in cats], dtype=torch.float32, device=device)
    out = []
    for _ in range(traffic["pool"]):
        half = torch.rand(B, 1, 3, generator=gen, device=device) * 0.3 + 0.2
        half = half / (2 * half.norm(dim=-1, keepdim=True))
        pts = (torch.rand(B, n, 3, generator=gen, device=device) * 2 - 1) * half
        face = torch.randint(0, 3, (B, n, 1), generator=gen, device=device)
        sign = torch.randint(0, 2, (B, n, 1), generator=gen, device=device) * 2 - 1
        on_face = torch.arange(3, device=device) == face
        pts = torch.where(on_face, half * sign, pts)
        lo, hi = box["scale_m"]
        scale = torch.rand(B, 1, 1, generator=gen, device=device) * (hi - lo) + lo
        R = rotations(gen, B, device)
        t = placements(gen, B, box, device)
        obs = scale * pts @ R.transpose(1, 2) + t[:, None, :]
        cat = torch.randint(0, len(cats), (B,), generator=gen, device=device)
        u = torch.rand(B, 9, generator=gen, device=device)
        (blo, bhi), shift, deg = ld["box_scale"], ld["shift_m"], ld["angle_deg"]
        extent = pts.amax(1) - pts.amin(1)
        batch = {"pcl_in": obs, "rotation": R, "translation": t, "cat_id": cat.to(torch.int32),
                 "handle_visibility": torch.ones(B, dtype=torch.int32, device=device),
                 "fsnet_scale": extent * scale[:, 0] - mean_shape[cat],
                 "mean_shape": mean_shape[cat], "sym_info": sym[cat],
                 "aug_bb": u[:, :3] * (bhi - blo) + blo,
                 "aug_rt_t": (u[:, 3:6] * 2 - 1) * shift,
                 "aug_rt_R": euler_rotations((u[:, 6:] * 2 - 1) * deg),
                 "model_point": pts, "nocs_scale": scale[:, 0, 0]}
        out.append({k: v.cpu().numpy() for k, v in batch.items()})
    return out


def augment_draws(gen: torch.Generator, traffic: Dict, device) -> Dict[str, torch.Tensor]:
    """The draws of one step's 3D augmentation, as ``process_batch`` takes
    them: the four flags' uniforms [batch, 1], the box-cage factors [batch,
    1] in ``cage``, the per-point jitter [batch, points, 3] in [0, 1)."""
    B, n = traffic["batch"], traffic["points"]
    lo, hi = traffic["pts_aug_draws"]["cage"]
    u = torch.rand(B, 6, generator=gen, device=device)
    out = {k: u[:, i:i + 1] for i, k in enumerate(("bb", "rt", "bc", "pc"))}
    out["ey_up"], out["ey_down"] = (u[:, 4:5] * (hi - lo) + lo, u[:, 5:6] * (hi - lo) + lo)
    out["jitter"] = torch.rand(B, n, 3, generator=gen, device=device)
    return out


def dsm_draws(gen: torch.Generator, repeat: int, batch: int, device) -> Tuple[torch.Tensor, ...]:
    """The DSM draws of one step: t ~ U(eps, 1) [repeat, batch, 1] and
    z ~ N(0, I) [repeat, batch, 9]."""
    eps = 1e-5
    u = torch.rand(repeat, batch, 1, generator=gen, device=device)
    return (torch.clamp(u * (1.0 - eps) + eps, min=eps),
            torch.randn(repeat, batch, 9, generator=gen, device=device))
