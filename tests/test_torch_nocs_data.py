"""genpose_tpu_torch's NOCS training data against the JAX package's.

- ``aug_bbox_DZI`` for each ``dzi_type`` and ``defor_2D`` (against the JAX
  package's, which calls cv2, and the erosion / dilation against cv2 itself,
  masks touching the border included): exact, from the same numpy seed.
- ``NOCSDataset.fetch(index, visit)``: every key of every sample equal to
  the JAX dataset's, arrays bit for bit, on a tree written by the JAX
  writer (cv2's PNGs) and one written by the port's (``utils/png.py``): train
  and test modes, the CAMERA, Real and CAMERA+Real sources, ``per_obj``,
  a mug's handle from ``mug_handle.pkl`` (a dict per scene, a missing frame,
  a list), and a deleted depth PNG skipping to the next index on both sides.
- ``camera_real_indices`` and the loaders of ``get_data_loaders_from_cfg``:
  the port's batches equal the JAX loader's over two epochs, in thread mode
  here and in process mode in a fresh interpreter (a fork of this
  multithreaded test process is not the supported shape; the JAX package's
  own process test runs the same way).
- The loader's lifecycle: an abandoned iterator stops its producer, and a
  worker's error is raised in the consumer.

Exact equality throughout: both packages run the same numpy draws in the
same order, and the port's PNG decode, crop and sampler are bit-exact
against cv2 and the native kernel (``tests/test_torch_dataset_utils.py``).
"""

import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from genpose_tpu import native
from genpose_tpu.config import DynamicZoomInConfig
from genpose_tpu.data import dataset_utils as jdu
from genpose_tpu.data import loader as jloader
from genpose_tpu.data import nocs as jnocs
from genpose_tpu.data import synthetic as jsyn
from genpose_tpu_torch.data import dataset_utils as tdu
from genpose_tpu_torch.data import loader as tloader
from genpose_tpu_torch.data import nocs as tnocs
from genpose_tpu_torch.data import synthetic as tsyn

ROOT = Path(__file__).resolve().parent.parent
N_PTS = 96
# 12 CAMERA and 1 Real train scenes: the 3:1 resampling repeats the Real one 3 times
TREE = dict(n_camera_scenes=12, n_real_scenes=1, seed=5)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same scenes written by each package's writer."""
    assert native.available(), "the JAX package's host kernel did not build"
    base = tmp_path_factory.mktemp("nocs")
    return {"jax": jsyn.make_synthetic_nocs_dir(str(base / "jax"), **TREE),
            "port": tsyn.make_synthetic_nocs_dir(str(base / "port"), **TREE)}


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)


def _datasets(root, **kw):
    kw.setdefault("n_pts", N_PTS)
    return jnocs.NOCSDataset(data_dir=root, **kw), tnocs.NOCSDataset(data_dir=root, **kw)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dzi_type", ["uniform", "roi10d", "none"])
def test_aug_bbox_dzi_equals_jax(dzi_type):
    params = DynamicZoomInConfig(dzi_type=dzi_type)
    box_rng = np.random.default_rng(1)
    j_rng, t_rng = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(64):
        x1, y1 = box_rng.integers(-20, 600), box_rng.integers(-20, 440)
        box = np.array([x1, y1, x1 + box_rng.integers(1, 400), y1 + box_rng.integers(1, 400)])
        jc, js = jdu.aug_bbox_DZI(params, box, 480, 640, j_rng)
        tc, ts = tdu.aug_bbox_DZI(params, box, 480, 640, t_rng)
        np.testing.assert_array_equal(tc, jc)
        assert ts == js and type(ts) is type(js)
    assert t_rng.random() == j_rng.random()  # the same number of draws


def _mask(kind, rng):
    if kind == "empty":
        return np.zeros((1, 24, 32), np.float32)
    if kind == "full":
        return np.ones((1, 24, 32), np.float32)
    m = np.zeros((1, 24, 32), np.float32)
    if kind == "border":  # touches all four edges and the corners
        m[0, :7, :9] = m[0, -5:, -6:] = m[0, 10:14, 0] = m[0, 0, 20:] = 1.0
    else:
        m[0] = rng.random((24, 32)) > 0.6
        m[0, 6:18, 8:24] = 1.0
    return m


@pytest.mark.parametrize("kind,rand_pro", [
    ("blob", 1.0), ("blob", 0.0), ("border", 1.0), ("empty", 1.0), ("full", 1.0), ("blob", 0.5)],
    ids=["hit", "miss", "border", "empty-change-list", "full-mask", "half"])
def test_defor_2d_equals_jax(kind, rand_pro):
    """``rand_pro`` 1.0 always deforms, 0.0 never; an empty or full mask
    has an empty change list; the same generator state after."""
    for seed in range(8):
        m = _mask(kind, np.random.default_rng(seed))
        j_rng, t_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jdu.defor_2D(m, j_rng, rand_r=3, rand_pro=rand_pro)
        got = tdu.defor_2D(m, t_rng, rand_r=3, rand_pro=rand_pro)
        assert got.dtype == want.dtype and got.shape == want.shape == m.shape[1:]
        np.testing.assert_array_equal(got, want)
        assert t_rng.random() == j_rng.random()
        if kind == "blob" and rand_pro == 1.0:
            assert not np.array_equal(got, m[0])  # the deformation happened


def test_erode_dilate_equal_cv2_with_the_2x2_ellipse():
    """The morphology ``defor_2D`` runs: cv2's 2x2 ellipse, one iteration
    (``rand_r`` lands in the ``dst`` slot), cv2's default border."""
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2, 2))
    rng = np.random.default_rng(0)
    for n in range(64):
        h, w = rng.integers(1, 20, 2)
        m = (rng.random((h, w)) > rng.random()).astype(np.float32)
        if n % 4 == 0:
            m[0, :] = m[:, 0] = 1.0  # set along the top and left edges
        erode, dilate = tdu._erode_dilate_2x2(m)
        np.testing.assert_array_equal(erode, cv2.erode(m, kernel, 3))
        np.testing.assert_array_equal(dilate, cv2.dilate(m, kernel, 3))


# ---------------------------------------------------------------------------
# NOCSDataset
# ---------------------------------------------------------------------------

DATASET_CASES = {
    "train-camera+real": dict(source="CAMERA+Real", mode="train"),
    "train-camera": dict(source="CAMERA", mode="train"),
    "train-real": dict(source="Real", mode="train"),
    "test-real": dict(source="Real", mode="test"),
    "test-camera": dict(source="CAMERA", mode="test"),
    "test-camera+real": dict(source="CAMERA+Real", mode="test"),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_nocs_fetch_equals_jax(trees, writer, case):
    jds, tds = _datasets(trees[writer], seed=3, **DATASET_CASES[case])
    assert len(tds) == len(jds) > 0
    assert tds.subset_len == jds.subset_len and tds.img_list == jds.img_list
    for index in range(len(jds)):
        for visit in (1, 2):
            _assert_samples_equal(tds.fetch(index, visit), jds.fetch(index, visit))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nocs_per_obj_equals_jax(trees, writer):
    root = trees[writer]
    counts = {}
    for cat in jnocs.CAT_NAMES:
        jds, tds = _datasets(root, source="CAMERA+Real", mode="train", per_obj=cat, seed=1)
        assert tds.img_list == jds.img_list and tds.subset_len == jds.subset_len
        counts[cat] = len(jds)
        for index in range(len(jds)):
            got, want = tds.fetch(index, 1), jds.fetch(index, 1)
            _assert_samples_equal(got, want)
            assert tnocs.CAT_NAMES[int(got["cat_id"])] == cat
    assert sum(counts.values()) > 0 and min(counts.values()) < len(
        _datasets(root, source="CAMERA+Real", mode="train")[1])  # the filter filtered


def test_nocs_mug_handle_equals_jax(tmp_path):
    """Real train mugs: the handle from ``mug_handle.pkl`` in each of its
    three cases (an entry of a scene's dict, a frame missing from it: 1, a
    scene stored as a list), and from the label in test mode."""
    root = tsyn.make_synthetic_nocs_dir(str(tmp_path / "mugs"), n_camera_scenes=1,
                                        n_real_scenes=3, seed=6)
    for split in ("train", "test"):
        with open(os.path.join(root, "Real", f"{split}_list.txt")) as f:
            for line in f.read().split():
                path = os.path.join(root, "Real", line + "_label.pkl")
                with open(path, "rb") as f2:
                    gts = pickle.load(f2)
                gts["class_ids"] = np.full_like(gts["class_ids"], 6)  # every instance a mug
                gts["handle_visibility"] = np.zeros_like(gts["handle_visibility"])
                with open(path, "wb") as f2:
                    pickle.dump(gts, f2)
    with open(os.path.join(root, "Real", "train", "mug_handle.pkl"), "wb") as f:
        pickle.dump({"scene_0_res": {0: 0}, "scene_1_res": {}, "scene_2_res": [0]}, f)
    want_handle = {"scene_0": 0, "scene_1": 1, "scene_2": 0}
    for mode in ("train", "test"):
        jds, tds = _datasets(root, source="Real", mode=mode, seed=2)
        for index in range(len(jds)):
            got, want = tds.fetch(index, 1), jds.fetch(index, 1)
            _assert_samples_equal(got, want)
            scene = got["path"].split("/")[-2]
            assert int(got["handle_visibility"]) == (want_handle[scene] if mode == "train" else 0)
            np.testing.assert_array_equal(
                got["sym_info"], tnocs.get_sym_info("mug", int(got["handle_visibility"])))


def test_nocs_missing_depth_skips_to_the_next_index(trees, tmp_path):
    root = str(tmp_path / "broken")
    shutil.copytree(trees["port"], root)
    jds, tds = _datasets(root, source="CAMERA", mode="train", seed=4)
    os.remove(os.path.join(root, tds.img_list[1] + "_depth.png"))
    got, want = tds.fetch(1, 1), jds.fetch(1, 1)
    _assert_samples_equal(got, want)
    assert got["path"].endswith(tds.img_list[2])
    assert not np.array_equal(got["pcl_in"], tds.fetch(2, 1)["pcl_in"])  # one generator


def test_nocs_dataset_pickles_and_numbers_visits():
    """``__getitem__`` numbers the visits of each index; a pickled copy
    (a process worker's) has its own lock and draws the same samples."""
    ds = tnocs.NOCSDataset.__new__(tnocs.NOCSDataset)
    calls = []
    ds.fetch = lambda index, visit: calls.append((index, visit)) or (index, visit)
    ds._visits, ds._visit_lock = {}, threading.Lock()
    assert [ds[0], ds[1], ds[0]] == [(0, 1), (1, 1), (0, 2)]
    del ds.fetch
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._visits == {0: 2, 1: 1} and copy._visit_lock is not ds._visit_lock


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subset_len,percentage", [([40, 3], 1.0), ([40, 3], 0.5), ([9, 4], 1.0),
                                                    ([5, 0], 1.0), ([300, 7], 0.25)])
def test_camera_real_indices_equal_jax(subset_len, percentage):
    got = tloader.camera_real_indices(subset_len, percentage, np.random.default_rng(6))
    want = jloader.camera_real_indices(subset_len, percentage, np.random.default_rng(6))
    np.testing.assert_array_equal(got, want)


def test_collate_equals_jax():
    samples = [{"a": np.full(3, i, np.float32), "b": np.int32(i), "path": f"p{i}"}
               for i in range(4)]
    _assert_samples_equal(tloader.collate(samples), jloader.collate(samples))


LOADER_FLAGS = ["--batch_size", "4", "--mini_bs", "3", "--num_points", str(N_PTS),
                "--num_workers", "3", "--seed", "9"]


def _epochs(loaders, n_epochs=2):
    out = {name: [list(ld) for _ in range(n_epochs)] for name, ld in sorted(loaders.items())}
    for ld in loaders.values():
        ld.close()
    return out


def _cfg_loaders(module_cfg, module_loader, root, extra=()):
    cfg = module_cfg.get_config(["--data_path", root] + LOADER_FLAGS + list(extra))
    return module_loader.get_data_loaders_from_cfg(cfg, ["train", "val", "test"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loaders_equal_jax_thread_mode(trees, writer):
    from genpose_tpu import config as jcfg
    from genpose_tpu_torch import config as tcfg

    want = _epochs(_cfg_loaders(jcfg, jloader, trees[writer]))
    got = _epochs(_cfg_loaders(tcfg, tloader, trees[writer]))
    assert set(got) == set(want) == {"train_loader", "val_loader", "test_loader"}
    for name in want:
        for g, w in zip(got[name], want[name]):
            _assert_batches_equal(g, w)
    train = got["train_loader"]
    assert all(len(b["path"]) == 4 for b in train[0])  # drop_last: a full batch exists
    real = [p for b in train[0] for p in b["path"] if "/Real/" in p]
    assert len(real) >= 2 and len(set(real)) == 1  # the Real scene, resampled
    assert not all(np.array_equal(a["aug_bb"], b["aug_bb"])  # epoch 2 draws afresh
                   for a, b in zip(train[0], train[1]))


_PROCESS_CHILD = """
import pickle, sys
sys.path.insert(0, {root!r})
from genpose_tpu import config as jcfg
from genpose_tpu.data import loader as jloader
from genpose_tpu_torch import config as tcfg
from genpose_tpu_torch.data import loader as tloader
out = {{}}
for name, cfg_mod, loader_mod in (("jax", jcfg, jloader), ("port", tcfg, tloader)):
    cfg = cfg_mod.get_config(["--data_path", {tree!r}, "--loader_mode", "process"] + {flags!r})
    loaders = loader_mod.get_data_loaders_from_cfg(cfg, ["train", "val", "test"])
    out[name] = {{k: [list(ld) for _ in range(2)] for k, ld in loaders.items()}}
    for ld in loaders.values():
        ld.close()
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
"""


def test_loaders_equal_jax_process_mode(trees, tmp_path):
    """Both packages' process-mode loaders in one fresh interpreter, each
    forking its pool at its first epoch, against the JAX thread-mode
    batches of this process."""
    out = str(tmp_path / "epochs.pkl")
    child = _PROCESS_CHILD.format(root=str(ROOT), tree=trees["port"], flags=LOADER_FLAGS, out=out)
    res = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        proc = pickle.load(f)
    from genpose_tpu import config as jcfg

    want = _epochs(_cfg_loaders(jcfg, jloader, trees["port"]))
    for side in ("jax", "port"):
        for name in want:
            for g, w in zip(proc[side][name], want[name]):
                _assert_batches_equal(g, w)


class _SlowDataset:
    """fetch(index, visit) sleeps; index ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def fetch(self, index, visit):
        if index == self.bad:
            raise KeyError(f"sample {index} is broken")
        time.sleep(0.01)
        return {"x": np.full(2, index, np.float32), "visit": np.int64(visit)}


def _producers():
    return [t for t in threading.enumerate() if t.daemon and t.name.startswith("Thread-")
            and t.is_alive()]


def test_abandoned_iterator_releases_its_producer():
    before = set(_producers())
    loader = tloader.DataLoader(_SlowDataset(64), batch_size=2, num_workers=2, prefetch=1,
                                shuffle=False)
    it = iter(loader)
    first = next(it)
    np.testing.assert_array_equal(first["x"][:, 0], [0, 1])
    del it  # the consumer leaves after one of 32 batches
    deadline = time.time() + 10
    while set(_producers()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(_producers()) - before, "the producer thread is still running"
    # the next epoch starts from the first batch, with the next visits
    again = next(iter(loader))
    np.testing.assert_array_equal(again["visit"], [2, 2])


def test_worker_error_surfaces_in_the_consumer():
    loader = tloader.DataLoader(_SlowDataset(12, bad=7), batch_size=2, num_workers=2,
                                shuffle=False)
    seen = []
    with pytest.raises(KeyError, match="sample 7 is broken"):
        for batch in loader:
            seen.append(batch)
    assert len(seen) == 3  # the batches before the broken one arrived
