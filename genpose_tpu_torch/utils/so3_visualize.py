"""SO(3) distribution pictures on a Mollweide projection (counterpart of
``genpose_tpu/utils/so3_visualize.py``; reference ``utils/so3_visualize.py:16-247``,
itself after implicit-PDF): each rotation is plotted at (longitude,
latitude) given by its ZXY Euler factorization, its tilt angle as hue.
The Euler extraction is closed-form numpy.  matplotlib is imported inside
the functions that draw (the card's machine has none); the PNG is written
with ``utils/png.py``.
"""

from __future__ import annotations

import numpy as np

from genpose_tpu_torch.utils import png


def matrix_to_euler_zxy(R: np.ndarray) -> np.ndarray:
    """Factor R = Rz(a0) @ Rx(a1) @ Ry(a2); returns (..., 3) = (a0, a1, a2).

    Matches pytorch3d's ``matrix_to_euler_angles(R, "ZXY")`` used by the
    reference (``so3_visualize.py:55-57``) away from gimbal lock.
    """
    R = np.asarray(R, np.float64)
    a1 = np.arcsin(np.clip(R[..., 2, 1], -1.0, 1.0))
    a0 = np.arctan2(-R[..., 0, 1], R[..., 1, 1])
    a2 = np.arctan2(-R[..., 2, 0], R[..., 2, 2])
    return np.stack([a0, a1, a2], axis=-1)


def visualize_so3_probabilities(
    rotations,
    probabilities,
    rotations_gt=None,
    chosen_rotation=None,
    ax=None,
    fig=None,
    display_threshold_probability=0.0,
    to_image=True,
    show_color_wheel=True,
    canonical_rotation=None,
    gt_size=600,
    chosen_size=300,
    y_offset=-30,
    dpi=300,
):
    """Tilt-colored Mollweide scatter of an SO(3) distribution
    (ref ``so3_visualize.py:16-178``).  Returns an (H, W, 3) uint8 image
    when ``to_image`` else the matplotlib figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rotations = np.asarray(rotations, np.float64)
    probabilities = np.asarray(probabilities, np.float64)
    if canonical_rotation is None:
        canonical_rotation = np.eye(3)

    if ax is None:
        fig = plt.figure(figsize=(4, 2), dpi=dpi)
        ax = fig.add_subplot(111, projection="mollweide")
    cmap = plt.cm.hsv

    def _show_single_marker(rotation, marker, edgecolors=True,
                            facecolors=False, s=gt_size):
        tilt, lat, lon = matrix_to_euler_zxy(rotation)
        color = cmap(0.5 + tilt / 2 / np.pi)
        ax.scatter(lon, lat, s=s,
                   edgecolors=color if edgecolors else "none",
                   facecolors=facecolors if facecolors else "none",
                   marker=marker, linewidth=5)

    display = rotations @ canonical_rotation
    eulers = matrix_to_euler_zxy(display)
    tilt_angles, latitudes, longitudes = eulers[:, 0], eulers[:, 1], eulers[:, 2]
    which = probabilities > display_threshold_probability

    for group, size in ((rotations_gt, gt_size), (chosen_rotation, chosen_size)):
        if group is None:
            continue
        group = np.asarray(group, np.float64)
        if group.ndim == 2:
            group = group[None]
        for rotation in group @ canonical_rotation:
            _show_single_marker(rotation, "o", s=size)
        for rotation in group @ canonical_rotation:  # white center cover-up
            _show_single_marker(rotation, "o", edgecolors=False,
                                facecolors="#ffffff", s=size)

    ax.scatter(longitudes[which], latitudes[which],
               s=4e3 * probabilities[which],
               c=cmap(0.5 + tilt_angles[which] / 2.0 / np.pi), marker=".")

    yticks = np.array([-60, -30, 0, 30, 60])
    ax.set_yticks(np.arange(-75, 90, 15) * np.pi / 180, minor=True)
    ax.set_yticks(yticks * np.pi / 180, [f"{y}°" for y in yticks], fontsize=10)
    xticks = np.array([-90, 0, 90])
    ax.set_xticks(xticks * np.pi / 180, [])
    ax.set_xticks(np.arange(-150, 180, 30) * np.pi / 180, minor=True)
    for xtick in xticks:
        ax.text(xtick * np.pi / 180, y_offset * np.pi / 180, f"{xtick}°",
                ha="center", va="center", fontsize=10)
    ax.grid(which="minor")
    ax.grid(which="major")

    if show_color_wheel:
        wheel = fig.add_axes([0.85, 0.12, 0.12, 0.12], projection="polar")
        theta = np.linspace(-3 * np.pi / 2, np.pi / 2, 200)
        radii = np.linspace(0.4, 0.5, 2)
        _, theta_grid = np.meshgrid(radii, theta)
        wheel.pcolormesh(theta, radii, (0.5 + theta_grid / np.pi / 2.0).T,
                         cmap=cmap, shading="auto")
        wheel.set_yticklabels([])
        wheel.set_xticks(np.arange(0, 2 * np.pi, np.pi / 2))
        wheel.set_xticklabels(["90°", "180°", "270°", "0°"], fontsize=6)
        wheel.spines["polar"].set_visible(False)
        wheel.grid(False)
        plt.text(0.5, 0.5, "Roll", fontsize=6, ha="center", va="center",
                 transform=wheel.transAxes)

    if to_image:
        img = plot_to_image(fig)
        plt.close(fig)
        return img
    return fig


def plot_to_image(fig) -> np.ndarray:
    """Rasterize a figure to (H, W, 3) uint8 (ref ``so3_visualize.py:180-188``)."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def visualize_so3(save_path, pred_rotations, gt_rotation=None,
                  pred_rotation=None, probabilities=None, image=None):
    """Save an SO(3)-distribution png (ref ``so3_visualize.py:213-247``),
    ``image`` resized beside it when given; returns the RGB array written
    (the JAX function writes it with ``plt.imsave``)."""
    pred_rotations = np.asarray(pred_rotations)
    if probabilities is None:
        probabilities = np.ones(pred_rotations.shape[0]) / 200
    img = visualize_so3_probabilities(
        rotations=pred_rotations,
        probabilities=probabilities,
        rotations_gt=gt_rotation,
        chosen_rotation=pred_rotation,
        to_image=True,
    )
    if image is not None:
        from genpose_tpu_torch.utils.visualize import resize_img_keep_ratio
        side = resize_img_keep_ratio(np.asarray(image), [img.shape[0], img.shape[0]])
        img = np.concatenate([side, img], axis=1)
    png.imwrite(save_path, img[..., ::-1])
    return img
