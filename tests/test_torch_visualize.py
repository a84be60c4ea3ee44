"""The port's drawing utilities (``genpose_tpu_torch/utils/visualize.py``,
``utils/so3_visualize.py``, ``ops/pose.py::transform_batch_pts``,
``MetricsLogger.image``) and the training CLI's pictures, against the JAX
package on the same numpy inputs.

- ``transform_batch_pts`` within 1e-6 (float32 rotation and sum; both
  packages take R x + t, or R^T (x - t) for the inverse pose).
- ``project_pts_to_image``, ``create_grid_image`` and
  ``resize_img_keep_ratio`` pixel for pixel: the splats round float64
  projections of the same float32 points, and the port's resize reproduces
  cv2's INTER_LINEAR fixed point exactly (also on random shapes against
  ``cv2.resize`` itself).
- ``test_time_visualize``: ``res_grid.png`` (decoded with ``utils/png.py``)
  equals the JAX file; each PNG frame equals JAX's ``create_grid_image``
  image of that step (the JAX video is lossy mp4, so the images it is
  encoded from are compared), and each sample has as many frames as the
  JAX video.
- ``matrix_to_euler_zxy`` within 1e-12 (both float64 numpy);
  ``visualize_so3``'s array equal to JAX's (the same matplotlib drawing).
- ``MetricsLogger.image`` hands a stub writer the image, and writes
  nothing without one.
- ``trainer.main --save_video true`` and ``--pred`` on the synthetic tree
  write the JAX trainer's files, the pictures equal to what the JAX drawing
  code draws from the same batch, poses and trajectory.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.ops import pose as jpose
from genpose_tpu.runners import trainer as jtrainer
from genpose_tpu.utils import so3_visualize as jso3
from genpose_tpu.utils import visualize as jvis
from genpose_tpu_torch.data.synthetic import make_synthetic_nocs_dir
from genpose_tpu_torch.ops import pose as tpose
from genpose_tpu_torch.runners import trainer
from genpose_tpu_torch.utils import png
from genpose_tpu_torch.utils import so3_visualize as tso3
from genpose_tpu_torch.utils import visualize as tvis
from genpose_tpu_torch.utils.logging import MetricsLogger


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs (the trainer cases
    share the machine with other tier-1 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot6d(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return q[..., :2].transpose(0, 2, 1).reshape(n, 6)


def _poses(rng, n, pose_mode):
    if pose_mode == "quat_wxyz":
        q = rng.normal(size=(n, 4))
        rot = q / np.linalg.norm(q, axis=1, keepdims=True)
    else:
        rot = _rot6d(rng, n)
    t = rng.normal(size=(n, 3)) * 0.05
    return np.concatenate([rot, t], axis=1).astype(np.float32)


def _clouds(rng, n, n_pts=256, color=False):
    pts = (rng.normal(size=(n, n_pts, 3)) * 0.08).astype(np.float32)
    if color:
        pts = np.concatenate([pts, rng.uniform(0, 255, (n, n_pts, 3)).astype(np.float32)], 2)
    return pts


@pytest.mark.parametrize("pose_mode", ["rot_matrix", "quat_wxyz"])
@pytest.mark.parametrize("inverse", [False, True])
def test_transform_batch_pts_matches_jax(pose_mode, inverse):
    rng = np.random.default_rng(0)
    pts, poses = _clouds(rng, 5, color=True), _poses(rng, 5, pose_mode)
    want = np.asarray(jpose.transform_batch_pts(jnp.asarray(pts), jnp.asarray(poses),
                                                pose_mode, inverse))
    got = tpose.transform_batch_pts(torch.from_numpy(pts), torch.from_numpy(poses),
                                    pose_mode, inverse).numpy()
    assert got.shape == (5, 256, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3:], pts[..., 3:])


@pytest.mark.parametrize("color", [False, True])
def test_project_pts_to_image_is_pixel_equal(color):
    rng = np.random.default_rng(1)
    pts = _clouds(rng, 1, color=color)[0]
    for view in (jvis._FRONT_VIEW, jvis._TOP_VIEW):
        want = jvis.project_pts_to_image(pts, camera_extrinsics=view)
        got = tvis.project_pts_to_image(pts, camera_extrinsics=view)
        assert got.dtype == np.uint8 and got.shape == (360, 360, 3)
        np.testing.assert_array_equal(got, want)
        assert (got != 255).any()


@pytest.mark.parametrize("case", ["pred_only", "pred_and_gt", "color_images", "inverse_quat"])
def test_create_grid_image_is_pixel_equal(case):
    rng = np.random.default_rng(2)
    pose_mode = "quat_wxyz" if case == "inverse_quat" else "rot_matrix"
    n = 18 if case == "pred_only" else 3  # more than 16 rows are cut to 16
    pts, pred = _clouds(rng, n), _poses(rng, n, pose_mode)
    gt = None if case == "pred_only" else _poses(rng, n, pose_mode)
    color = (rng.integers(0, 256, (n, 3, 120, 160)).astype(np.uint8)
             if case == "color_images" else None)
    args = (pts, pred, gt, color, pose_mode, case == "inverse_quat")
    want_grid, want_images = jvis.create_grid_image(*args)
    got_grid, got_images = tvis.create_grid_image(*args)
    np.testing.assert_array_equal(got_grid, want_grid)
    np.testing.assert_array_equal(got_images, want_images)
    cols = 2 + (gt is not None) * 2 + (color is not None)
    assert got_images.shape == (min(n, 16), 360, 360 * cols, 3)


@pytest.mark.parametrize("shape,target", [((120, 160, 3), (360, 360)), ((360, 1440, 3), (600, 600)),
                                          ((37, 53, 3), (90, 61)), ((480, 640, 3), (100, 100))])
def test_resize_img_keep_ratio_is_pixel_equal_to_cv2(shape, target):
    img = np.random.default_rng(3).integers(0, 256, shape).astype(np.uint8)
    want = jvis.resize_img_keep_ratio(img, list(target))
    got = tvis.resize_img_keep_ratio(img, list(target))
    assert got.shape == want.shape == (*target, 3)
    np.testing.assert_array_equal(got, want)


def test_resize_linear_equals_cv2_on_random_shapes():
    """``cv2.resize`` INTER_LINEAR of uint8 images, up and down, 1-4 channels."""
    rng = np.random.default_rng(4)
    for _ in range(60):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 90, 4))
        shape = (h, w) if rng.random() < 0.2 else (h, w, int(rng.integers(1, 5)))
        img = rng.integers(0, 256, shape).astype(np.uint8)
        want = cv2.resize(img, (nw, nh))
        got = tvis.resize_linear_u8(img, (nh, nw)).reshape(want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} -> {(nh, nw)}")


def _trajectory(rng, bs, steps):
    return np.stack([_poses(rng, bs, "rot_matrix") for _ in range(steps)], axis=1)


def _jax_frames(pts, traj, gt, o2c):
    """The images JAX's ``save_video`` encodes: ``create_grid_image`` of each
    step ``test_time_visualize`` keeps."""
    steps = traj.transpose(1, 0, 2)
    steps = steps[-steps.shape[0] // 2:]
    if steps.shape[0] > 100:
        steps = steps[:: steps.shape[0] // 100]
    return [jvis.create_grid_image(pts, s, gt, None, "rot_matrix", o2c)[1] for s in steps]


def _mp4_frames(path):
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def _check_video_dir(got_dir, want_dir, pts, res, traj, gt, o2c):
    """``res_grid.png`` equal to the JAX file, and every sample's frames equal
    to the images of JAX's video (as many as the video holds)."""
    np.testing.assert_array_equal(png.imread(os.path.join(got_dir, "res_grid.png")),
                                  png.imread(os.path.join(want_dir, "res_grid.png")))
    n = min(pts.shape[0], 16)
    frames = _jax_frames(pts[:n], traj[:n], None if gt is None else gt[:n], o2c)
    for i in range(n):
        names = sorted(os.listdir(os.path.join(got_dir, f"example_{i}")))
        assert names == [f"frame_{k:04d}.png" for k in range(len(frames))]
        for k, name in enumerate(names):
            rgb = png.imread(os.path.join(got_dir, f"example_{i}", name))[..., ::-1]
            np.testing.assert_array_equal(rgb, frames[k][i], err_msg=f"example {i} frame {k}")
        mp4 = os.path.join(want_dir, f"example_{i}.mp4")
        assert _mp4_frames(mp4) == len(frames)
    assert not os.path.exists(os.path.join(got_dir, f"example_{n}"))
    return len(frames)


@pytest.mark.parametrize("steps", [9, 402])
def test_test_time_visualize_matches_jax(tmp_path, steps):
    """9 steps keep the last 5 as frames; 402 keep the last 201, every
    second of them (101 frames), as JAX's slicing does."""
    rng = np.random.default_rng(5)
    bs = 3 if steps == 9 else 1
    pts, res, gt = _clouds(rng, bs), _poses(rng, bs, "rot_matrix"), _poses(rng, bs, "rot_matrix")
    traj = _trajectory(rng, bs, steps)
    data = {"pts": pts, "gt_pose": gt}
    jvis.test_time_visualize(str(tmp_path / "jax"), data, res, traj, "rot_matrix", True)
    written = tvis.test_time_visualize(str(tmp_path / "port"), data, res, traj, "rot_matrix",
                                       True)
    n = _check_video_dir(str(tmp_path / "port"), str(tmp_path / "jax"), pts, res, traj, gt, True)
    assert written == n * bs


def test_matrix_to_euler_zxy_matches_jax():
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.normal(size=(64, 3, 3)))
    R = q * np.sign(np.linalg.det(q))[:, None, None]
    np.testing.assert_allclose(tso3.matrix_to_euler_zxy(R), jso3.matrix_to_euler_zxy(R),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_image", [False, True])
def test_visualize_so3_matches_jax(tmp_path, with_image):
    """The array drawn (and, decoded, the file written) equals JAX's; with
    ``image`` the grid is resized beside the scatter (cv2 on the JAX side)."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(20, 3, 3)))
    rots = q * np.sign(np.linalg.det(q))[:, None, None]
    image = None
    if with_image:
        image, _ = tvis.create_grid_image(_clouds(rng, 1), _poses(rng, 1, "rot_matrix"),
                                          _poses(rng, 1, "rot_matrix"))
    kw = dict(pred_rotations=rots, gt_rotation=rots[:1], pred_rotation=rots[1:2],
              probabilities=rng.uniform(0, 0.01, 20), image=image)
    want = jso3.visualize_so3(save_path=str(tmp_path / "jax.png"), **kw)
    got = tso3.visualize_so3(save_path=str(tmp_path / "port.png"), **kw)
    assert got.shape == want.shape == (600, 1200 + 600 * with_image, 3)
    np.testing.assert_array_equal(got, want)
    written = png.imread(str(tmp_path / "port.png"))[..., ::-1]
    np.testing.assert_array_equal(written, got)
    # plt.imsave writes RGBA, which cv2 reads as BGR
    np.testing.assert_array_equal(written, cv2.imread(str(tmp_path / "jax.png"))[..., ::-1])


def test_metrics_logger_image(tmp_path):
    class Stub:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, step):
            self.images.append((tag, img, step))

    logger = MetricsLogger(str(tmp_path), use_tensorboard=False)
    img = np.zeros((3, 4, 5), np.uint8)
    logger.image("val/pose_render", img, 3)  # no writer: nothing, and no error
    logger.writer = Stub()
    logger.image("val/pose_render", img, 3)
    assert logger.writer.images == [("val/pose_render", img, 3)]
    logger.writer = None
    logger.close()
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


# ---------------------------------------------------------------------------
# the training CLI's pictures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_nocs_dir(str(tmp_path_factory.mktemp("nocs") / "tree"),
                                   n_camera_scenes=8, n_real_scenes=2, seed=3)


def _flags(tree, log_dir, *extra):
    return ["--data_path", tree, "--device", "cpu", "--batch_size", "4", "--mini_bs", "4",
            "--num_points", "128", "--repeat_num", "2", "--sampling_steps", "8",
            "--warmup", "2", "--num_workers", "2", "--log_dir", log_dir, *extra]


@pytest.mark.parametrize("sampler", ["ode", "ode_adaptive"])
def test_trainer_save_video_writes_the_jax_files(tree, tmp_path, monkeypatch, sampler):
    """One score epoch with an eval epoch: ``video_epoch1_{train,val}`` with
    ``res_grid.png`` and the frames, equal to what the JAX trainer's
    ``_visualize_eval`` draws from the same batch, poses and trajectory;
    under ``ode_adaptive`` the trajectory comes from the fixed-step PF-ODE
    (8 steps: 4 frames), as in JAX."""
    seen, orig = [], trainer._visualize_eval

    def spy(cfg, logger, batch, pred, process, mode, epoch):
        seen.append((cfg, {k: batch[k].cpu().numpy() for k in ("pts", "gt_pose")},
                     pred.cpu().numpy(), process.cpu().numpy(), mode, epoch))
        return orig(cfg, logger, batch, pred, process, mode, epoch)

    monkeypatch.setattr(trainer, "_visualize_eval", spy)
    out = str(tmp_path / "port")
    trainer.main(["--agent_type", "score", "--n_epochs", "1", "--eval_freq", "1",
                  "--save_video", "true", "--sampler_mode", sampler]
                 + _flags(tree, "vid"), out_dir=out)
    assert [s[4] for s in seen] == ["train", "val"]

    class NoImages:
        def image(self, tag, img, step):
            assert img.shape[0] == 3

    for cfg, batch, pred, process, mode, epoch in seen:
        assert process.shape == (4, 8, 9) and pred.shape == (4, 9)
        jax_dir = str(tmp_path / "jax")
        jtrainer._visualize_eval(cfg, NoImages(), batch, pred, process[:, None], mode, epoch,
                                 jax_dir)
        name = f"video_epoch{epoch}_{mode}"
        n = _check_video_dir(os.path.join(out, "logs", "vid", name),
                             os.path.join(jax_dir, name), batch["pts"], pred, process,
                             batch["gt_pose"], cfg.o2c_pose)
        assert n == 4


def test_trainer_pred_writes_the_jax_files(tree, tmp_path, monkeypatch):
    """``--pred`` of a score run: ``prediction_results.pkl`` and
    ``so3_distribution_<i>.png`` for each object of the first batch (2 Real
    test scenes), each equal to the JAX trainer's drawing code (its
    ``prediction``'s lines 408-429) on the same results."""
    import jax.numpy as jnp

    seen, orig = {}, trainer._visualize_prediction

    def spy(cfg, first, save_dir):
        seen.update(cfg=cfg, first=first)
        return orig(cfg, first, save_dir)

    monkeypatch.setattr(trainer, "_visualize_prediction", spy)
    out = str(tmp_path / "port")
    trainer.main(["--agent_type", "score", "--pred", "true", "--max_eval_num", "0"]
                 + _flags(tree, "pred"), out_dir=out)
    pred_dir = os.path.join(out, "predictions", "pred")
    first, cfg = seen["first"], seen["cfg"]
    n = first["pred_pose"].shape[0]
    assert n == 2 and sorted(os.listdir(pred_dir)) == ["prediction_results.pkl"] + [
        f"so3_distribution_{i}.png" for i in range(n)]

    def rot(q):  # the JAX code's rotations
        return np.asarray(jpose.get_rot_matrix(jnp.asarray(q), "quat_wxyz"))

    for i in range(n):
        grid, _ = jvis.create_grid_image(first["pts"][i:i + 1], first["average_pred_pose"][i:i + 1],
                                         first["gt_pose"][i:i + 1], None, pose_mode="quat_wxyz",
                                         inverse_pose=cfg.o2c_pose)
        want = jso3.visualize_so3(
            save_path=str(tmp_path / f"jax_{i}.png"),
            pred_rotations=rot(first["pred_pose"][i][:, :-3]),
            pred_rotation=rot(first["average_pred_pose"][i:i + 1, :-3]),
            gt_rotation=rot(first["gt_pose"][i:i + 1, :-3]), image=grid)
        got = png.imread(os.path.join(pred_dir, f"so3_distribution_{i}.png"))[..., ::-1]
        assert got.shape == want.shape == (600, 1800, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"object {i}")


def test_drawing_without_matplotlib_is_skipped_with_a_line(tree, tmp_path, monkeypatch, capsys):
    """As the JAX trainer does where its drawing libraries are missing (the
    card's machine has no matplotlib): the SO(3) images are skipped with
    the reason printed, and the flow writes its results."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    out = str(tmp_path / "port")
    trainer.main(["--agent_type", "score", "--pred", "true", "--max_eval_num", "0"]
                 + _flags(tree, "nompl"), out_dir=out)
    assert "visualization skipped: No module named 'matplotlib'" in capsys.readouterr().out
    assert os.listdir(os.path.join(out, "predictions", "nompl")) == ["prediction_results.pkl"]
