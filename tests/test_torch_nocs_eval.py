"""genpose_tpu_torch.eval.nocs_eval against the JAX package's, function by function.

Inputs are seeded numpy arrays; both sides get copies of the same arrays.
Every output is held equal, bit for bit, NaN for NaN: the protocol is
float64 numpy on both sides.  The one exception is the quaternion-averaged
pose of ``sort_sRT_by_energy(..., "average")``: both pool in float32
through their pose core (``jnp`` there, CPU tensors here), whose 4x4
eigen-solves differ in the last bits, so it is held within 1e-6 (float32
resolution); the mAP tables built on it are identical.
"""

import copy
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from genpose_tpu.eval import nocs_eval as J
from genpose_tpu_torch.eval import nocs_eval as T

NAMES = J.SYNSET_NAMES_BG


def _srt(R, t, s=1.0):
    m = np.eye(4)
    m[:3, :3] = s * R
    m[:3, 3] = t
    return m


def _rot(rng, deg):
    axis = rng.normal(size=3)
    return Rotation.from_rotvec(axis / np.linalg.norm(axis) * np.radians(deg)).as_matrix()


def _scene(rng, n_gt=4, K=6):
    """A scene with hypotheses 0-25 degrees and 0-8 cm off, some mugs with
    the handle hidden, one missed object and one false positive."""
    gt_ids = rng.integers(1, 7, n_gt)
    gt_ids[0] = 6
    gt_rts, gt_scales, gt_bboxes = [], [], []
    p_ids, p_rts, p_energy, p_scores, p_bboxes, p_scales = [], [], [], [], [], []
    for i, cls in enumerate(gt_ids):
        R = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(0.8, 1.2)])
        scale = rng.uniform(0.1, 0.3, 3)
        gt_rts.append(_srt(R, t, rng.uniform(0.8, 1.2)))
        gt_scales.append(scale)
        box = np.array([20 + 60 * i, 30 + 70 * i, 60 + 60 * i, 80 + 70 * i])
        gt_bboxes.append(box)
        if i == n_gt - 1:  # missed by the detector
            continue
        p_ids.append(cls)
        p_rts.append(np.stack([_srt(_rot(rng, rng.uniform(0, 25)) @ R,
                                    t + rng.normal(scale=0.03, size=3))
                               for _ in range(K)]))
        p_energy.append(rng.normal(size=(K, 2)))
        p_scores.append(rng.uniform(0.5, 1.0))
        p_bboxes.append(box + rng.integers(-8, 9, 4))
        p_scales.append(scale * rng.uniform(0.9, 1.1, 3))
    fp = next(c for c in range(1, 7) if c not in set(gt_ids.tolist()))
    p_ids.append(fp)
    p_rts.append(np.tile(np.eye(4), (K, 1, 1)))
    p_energy.append(rng.normal(size=(K, 2)))
    p_scores.append(0.4)
    p_bboxes.append(np.array([400, 400, 440, 450]))
    p_scales.append(np.full(3, 0.2))
    return {
        "gt_class_ids": gt_ids, "gt_RTs": np.stack(gt_rts), "gt_scales": np.stack(gt_scales),
        "gt_handle_visibility": rng.integers(0, 2, n_gt), "gt_bboxes": np.stack(gt_bboxes),
        "pred_class_ids": np.array(p_ids), "multi_hypothesis_pred_RTs": np.stack(p_rts),
        "energy": np.stack(p_energy), "pred_scores": np.array(p_scores),
        "pred_bboxes": np.stack(p_bboxes), "pred_scales": np.stack(p_scales),
    }


SCENES = [_scene(np.random.default_rng(s)) for s in range(6)]


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert np.asarray(a).shape == np.asarray(b).shape


def _both(name, *args, **kwargs):
    want = getattr(J, name)(*copy.deepcopy(args), **kwargs)
    got = getattr(T, name)(*copy.deepcopy(args), **kwargs)
    _same(want, got)
    return got


def test_boxes_and_transforms():
    rng = np.random.default_rng(0)
    for _ in range(10):
        size, shift = rng.uniform(0.05, 0.5, 3), rng.normal(size=3)
        corners = _both("get_3d_bbox", size, shift)
        _both("transform_coordinates_3d", corners, _srt(_rot(rng, 40), rng.normal(size=3), 1.3))


@pytest.mark.parametrize("cls_a, cls_b, hv", [
    ("camera", "camera", 1), ("bottle", "bottle", 1), ("bowl", "bowl", 1), ("can", "can", 0),
    ("mug", "mug", 0), ("mug", "mug", 1), ("laptop", "mug", 0)])
def test_compute_3d_iou(cls_a, cls_b, hv):
    """Includes the per-corner ``amax`` quirk and the 20-step y sweep of the
    symmetric classes (mug only with its handle hidden)."""
    rng = np.random.default_rng(1)
    for _ in range(8):
        R = _rot(rng, 180)
        a = _srt(_rot(rng, 30) @ R, rng.normal(scale=0.03, size=3) + [0, 0, 1])
        b = _srt(R, np.array([0, 0, 1.0]))
        _both("compute_3d_IoU", a, b, rng.uniform(0.1, 0.3, 3), rng.uniform(0.1, 0.3, 3),
              cls_a, cls_b, hv)
    assert T.compute_3d_IoU(None, b, [1, 1, 1], [1, 1, 1], "mug", "mug", 1) == -1.0


def test_greedy_and_iou_matches():
    rng = np.random.default_rng(2)
    overlaps = rng.uniform(0, 1, (6, 5)).astype(np.float32)
    pred_ids, gt_ids = rng.integers(1, 3, 6), rng.integers(1, 3, 5)
    for thresholds, score in (([0.1, 0.5, 0.75], 0), ([0.25], 0.5)):
        _both("_greedy_match", overlaps, thresholds, pred_ids, gt_ids, score)
    for sc in SCENES:
        _both("compute_2d_IoU", sc["pred_bboxes"][0], sc["gt_bboxes"][0])
        _both("compute_2d_IoU_matches", sc["gt_class_ids"], sc["gt_bboxes"],
              sc["pred_class_ids"], sc["pred_bboxes"], sc["pred_scores"], [0.1, 0.5])
        _both("compute_IoU_matches", sc["gt_class_ids"], sc["gt_RTs"], sc["gt_scales"],
              sc["gt_handle_visibility"], sc["pred_class_ids"],
              sc["multi_hypothesis_pred_RTs"][:, 0], sc["pred_scales"], sc["pred_scores"],
              NAMES, [0.1, 0.25, 0.5])


def test_rt_overlaps_and_matches():
    for sc in SCENES:
        ov = _both("compute_RT_overlaps", sc["gt_class_ids"], sc["gt_RTs"],
                   sc["gt_handle_visibility"], sc["pred_class_ids"],
                   sc["multi_hypothesis_pred_RTs"][:, 0], NAMES)
        _both("compute_RT_matches", ov, sc["pred_class_ids"], sc["gt_class_ids"],
              list(range(0, 46, 5)) + [360], [0, 1, 2, 5, 10, 100])
    empty = np.zeros((0, 3, 2))
    _both("compute_RT_matches", empty, np.zeros(0), [1, 2, 3], [5, 10], [2, 5])


def test_ap_and_acc():
    rng = np.random.default_rng(3)
    for n_pred, n_gt in ((7, 5), (1, 3), (4, 0)):
        pm = np.where(rng.random(n_pred) > 0.4, rng.integers(0, max(n_gt, 1), n_pred), -1)
        _both("compute_ap_and_acc", pm.astype(float), rng.random(n_pred),
              -np.ones(n_gt))
    ap, acc = T.compute_ap_and_acc(np.zeros(0), np.zeros(0), np.zeros(0))
    assert np.isnan(acc)  # an empty class: nan, as the reference


def test_sort_srt():
    rng = np.random.default_rng(4)
    poses = rng.normal(size=(3, 6, 4, 4))
    energy = rng.normal(size=(3, 6, 2))
    energy[0, 1] = energy[0, 4]  # ties keep their order on both sides
    _both("sort_sRT", poses, energy)


@pytest.mark.parametrize("mode", ["average", "nearest"])
@pytest.mark.parametrize("ranker", ["energy_ranker", "gt_ranker", "random"])
def test_sort_srt_by_energy(ranker, mode):
    sc = SCENES[0]
    srt, energy = sc["multi_hypothesis_pred_RTs"], sc["energy"]
    overlaps = np.random.default_rng(5).uniform(0, 30, (srt.shape[0], 2, srt.shape[1], 2))
    for ov in (overlaps, overlaps[:, :0]):  # the second: no GT of the class
        np.random.seed(6)
        want = J.sort_sRT_by_energy(srt.copy(), energy.copy(), ov, ranker, 0.6, mode)
        np.random.seed(6)
        got = T.sort_sRT_by_energy(srt.copy(), energy.copy(), ov, ranker, 0.6, mode)
        _same([want[0], want[2]], [got[0], got[2]])
        if mode == "nearest":
            assert got[1] is None and want[1] is None
        else:
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    _same(J.sort_sRT_by_energy(srt[:0], energy[:0], None, ranker, 0.6, mode),
          T.sort_sRT_by_energy(srt[:0], energy[:0], None, ranker, 0.6, mode))


@pytest.mark.parametrize("pooling", ["average", "nearest"])
@pytest.mark.parametrize("ranker", ["energy_ranker", "gt_ranker"])
def test_compute_map_tables_identical(tmp_path, ranker, pooling):
    """The whole protocol at the eval runner's grids (46 x 21 x 101), with
    one empty scene and the ratio of the released eval."""
    scenes = SCENES + [{**SCENES[0], "gt_class_ids": np.zeros(0, int),
                        "pred_class_ids": np.zeros(0, int)}]
    args = (list(range(46)), [i / 2 for i in range(21)], [i / 100 for i in range(101)])
    kw = dict(iou_pose_thres=0.1, use_matches_for_pose=True, pooling_mode=pooling,
              ratio=0.6, ranker=ranker)
    want = J.compute_mAP(copy.deepcopy(scenes), str(tmp_path / "jax"), *args, **kw)
    got = T.compute_mAP(copy.deepcopy(scenes), str(tmp_path / "port"), *args, **kw)
    _same(want, got)
    pose_aps = got[1]
    assert 0 < np.nanmax(pose_aps[1:-1, :-1, :-1]) and np.nanmin(pose_aps[1:-1, 5, 4]) < 1
    jp = open(tmp_path / "jax" / "mAP_Acc.pkl", "rb").read()
    assert jp == open(tmp_path / "port" / "mAP_Acc.pkl", "rb").read()


def test_plot_map_without_matplotlib(tmp_path, monkeypatch, capsys):
    """No matplotlib: one line says the curve was not drawn, nothing raises."""
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tables = np.zeros((8, 101)), np.zeros((8, 46, 21))
    out = T.plot_mAP(*tables, str(tmp_path), [i / 100 for i in range(101)], list(range(46)),
                     [i / 2 for i in range(21)], "x.png")
    assert out is None and not (tmp_path / "x.png").exists()
    assert "not drawn" in capsys.readouterr().out
