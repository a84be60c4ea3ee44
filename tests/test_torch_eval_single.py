"""genpose_tpu_torch.runners.evaluation_single against the JAX runner, stage by stage.

One synthetic Real/test tree of two scenes (the port's generator; the JAX
one writes the same tree, ``tests/test_torch_dataset_utils.py``) and its
Mask R-CNN pkls.  Both runners get the same weights (a derandomised JAX
agent pair, the port holding the score agent's EMA shadow and the energy
agent's live params) and the same prior rows (each score agent's prior
pinned to the first rows of ``NOISE``: both runners pad a chunk to
``batch_size`` with copies of its last instance, and each padded row takes
its own prior row).

- Stage 1: the segmentation cache is equal bit for bit.
- Stages 2-3: RTs and energies within rtol = atol = 1e-4, the serving
  tolerance (``tests/test_torch_serving.py``): the same float32 chain on
  the CPU, apart from GEMM summation order.  Under the Heun sampler and
  under the adaptive RK45 sampler, whose one step size for all rows makes
  the padded rows part of the real rows' integration.
- Stage 4: from the same results pkl, ``mAP_Acc.pkl``, the logs and
  ``mAP_headline.json`` are identical.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from genpose_tpu.config import get_config as jax_get_config
from genpose_tpu.runners import evaluation_single as jev
from genpose_tpu_torch.config import get_config
from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results, make_synthetic_nocs_dir
from genpose_tpu_torch.runners import evaluation_single as tev
from _torch_parity import jax_agent, pin_jax_prior, pin_port_prior, port_agent

TOL = dict(rtol=1e-4, atol=1e-4)
FLAGS = ["--test_source", "real_test", "--num_points", "128", "--eval_repeat_num", "3",
         "--sampling_steps", "4", "--T0", "0.55", "--batch_size", "4",
         "--pooling_mode", "average", "--eval_ratios", "0.6"]
NOISE = np.random.default_rng(0).normal(size=(4 * 3, 9)).astype(np.float32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_equal(a, b, where="", tol=None):
    """Deep equality of pickled results; float arrays within ``tol`` if given."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}", tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]", tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, where
        if tol and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=where, **tol)
        else:
            np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_single")
    nocs = make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1, n_real_scenes=2,
                                   seed=5)
    for side in ("jax", "port"):
        make_synthetic_mrcnn_results(nocs, str(root / side), "real_test")
    return root, nocs


def _cfgs(root, nocs, side, extra=()):
    argv = ["--data_path", nocs, "--result_dir", str(root / side)] + FLAGS + list(extra)
    return (jax_get_config if side == "jax" else get_config)(argv)


def _stages_2_and_3(root, nocs, out, name, extra=()):
    """Stages 2-3 of both runners from the stage-1 caches in ``out``, into
    root/{jax,port}/``name``."""
    jcfg, tcfg = _cfgs(root, nocs, "jax", extra), _cfgs(root, nocs, "port", extra)
    js, je = jax_agent(jcfg, "score", seed=1), jax_agent(jcfg, "energy", seed=2)
    ts, te = port_agent(tcfg, "score", js, use_ema=True), port_agent(tcfg, "energy", je, False)
    pin_jax_prior(js, NOISE)
    pin_port_prior(ts, NOISE)
    dirs = {side: str(root / side / name) for side in ("jax", "port")}
    jev.inference_pose(jcfg, js, out["jax"]["seg"], dirs["jax"], key=jax.random.PRNGKey(0))
    tev.inference_pose(tcfg, ts, out["port"]["seg"], dirs["port"])
    jev.inference_energy(jcfg, je, dirs["jax"])
    tev.inference_energy(tcfg, te, dirs["port"])
    return {side: {"seg": out[side]["seg"], "dir": dirs[side]} for side in dirs}


@pytest.fixture(scope="module")
def stages(tree):
    """Stages 1-3 of both runners on the tree, into root/{jax,port}."""
    root, nocs = tree
    jcfg, tcfg = _cfgs(root, nocs, "jax"), _cfgs(root, nocs, "port")
    out = {}
    for side, cfg, mod in (("jax", jcfg, jev), ("port", tcfg, tev)):
        seg = str(root / side / "seg" / "segmentation_results_real_test.pkl")
        mod.detect_mrcnn_results(cfg, seg)
        out[side] = {"seg": seg}
    return _stages_2_and_3(root, nocs, out, "inference")


@pytest.fixture(scope="module")
def stages_rk45(tree, stages):
    """Stages 2-3 of both runners under ``--sampler_mode ode_adaptive``."""
    root, nocs = tree
    return _stages_2_and_3(root, nocs, stages, "inference_rk45",
                           ["--sampler_mode", "ode_adaptive"])


def test_stage1_segmentation_cache_is_bit_equal(stages):
    want, got = _load(stages["jax"]["seg"]), _load(stages["port"]["seg"])
    assert [os.path.basename(k) for k in want] == [os.path.basename(k) for k in got]
    n_inst = 0
    for kj, kt in zip(want, got):
        assert kj.replace("/jax/", "/port/") == kt or kj == kt
        _assert_equal(want[kj], got[kt], kj)
        n_inst += len(got[kt]["valid_pts"])
        for pts in got[kt]["valid_pts"]:
            assert pts.dtype == np.float32 and pts.shape == (128, 3)
    assert n_inst >= 3
    logs = [open(s["seg"].replace("_results_", "_logs_").replace(".pkl", ".txt")).read()
            for s in (stages["jax"], stages["port"])]
    assert logs[0] == logs[1]


STAGE_FILES = ["results_wo_energy.pkl", "cls_data.pkl", "results_with_energy.pkl"]


@pytest.mark.parametrize("name", STAGE_FILES)
def test_stages_2_and_3_match_jax(stages, name):
    _check_stages_2_and_3(stages, name)


@pytest.mark.parametrize("name", STAGE_FILES)
def test_stages_2_and_3_match_jax_rk45(stages_rk45, name):
    """Each category chunk (1-2 instances) padded to 4 on both sides."""
    _check_stages_2_and_3(stages_rk45, name)


def _check_stages_2_and_3(stages, name):
    want = _load(os.path.join(stages["jax"]["dir"], name))
    got = _load(os.path.join(stages["port"]["dir"], name))
    if name == "cls_data.pkl":
        for cat in want:
            assert len(got[cat]["pred_pose"]) == len(want[cat]["pred_pose"]), cat
            if want[cat]["pred_pose"]:
                np.testing.assert_allclose(np.asarray(got[cat]["pred_pose"]),
                                           np.asarray(want[cat]["pred_pose"]), **TOL)
            _assert_equal(want[cat]["pts"], got[cat]["pts"], cat)
        return
    assert len(want) == len(got)
    for (kj, ej), et in zip(want.items(), got.values()):
        _assert_equal(ej, et, kj, tol=TOL)
        # the hypotheses moved off the identity: stages 2-3 really wrote them
        rts = et["result"]["multi_hypothesis_pred_RTs"][et["valid_inst"]]
        assert rts.shape[1] == 3 and not np.allclose(rts, np.eye(4))
        if name == "results_with_energy.pkl":
            e = et["result"]["energy"][et["valid_inst"]]
            assert (np.diff(e, axis=1) <= 0).all()  # sorted, descending


def _near_gt(results_pkl, out_dir, seed):
    """A copy of ``results_pkl`` whose hypotheses lie within 1 degree and
    0.5 cm of each instance's GT (the detections are the GT labels)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    data = _load(results_pkl)
    for entry in data.values():
        res = entry["result"]
        hyps = res["multi_hypothesis_pred_RTs"]
        for i in range(hyps.shape[0]):
            gt = res["gt_RTs"][i]
            R = gt[:3, :3] / np.cbrt(np.linalg.det(gt[:3, :3]))
            for k in range(hyps.shape[1]):
                axis = rng.normal(size=3)
                d = Rotation.from_rotvec(axis / np.linalg.norm(axis)
                                         * np.radians(rng.uniform(0, 1))).as_matrix()
                hyps[i, k] = np.eye(4)
                hyps[i, k, :3, :3] = d @ R
                hyps[i, k, :3, 3] = gt[:3, 3] + rng.uniform(-0.0029, 0.0029, 3)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results_with_energy.pkl"), "wb") as f:
        pickle.dump(data, f)


@pytest.mark.parametrize("ranker", ["energy_ranker", "gt_ranker"])
def test_stage4_tables_logs_and_headline_identical(stages, tree, ranker, monkeypatch):
    """The curves are not drawn here (``plot_mAP`` at 600 dpi takes seconds
    and writes nothing the tables or logs depend on)."""
    root, nocs = tree
    heads = {}
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "plot_mAP", lambda *args, **kwargs: None)
    for side, mod in (("jax", jev), ("port", tev)):
        cfg = _cfgs(root, nocs, side, ["--ranker", ranker])
        d = str(root / side / f"stage4_{ranker}")
        _near_gt(os.path.join(stages["jax"]["dir"], "results_with_energy.pkl"), d, seed=3)
        heads[side] = mod.evaluate(cfg, d)
        if side == "port":
            tev.write_headline(d, heads[side])
    jd, td = (str(root / s / f"stage4_{ranker}" / "results" / "average" / ranker)
              for s in ("jax", "port"))
    _assert_equal(_load(os.path.join(jd, "mAP_Acc.pkl")), _load(os.path.join(td, "mAP_Acc.pkl")))
    for log in ("eval_logs.txt", "eval_logs_single_cls.txt"):
        assert open(os.path.join(jd, log)).read() == open(os.path.join(td, log)).read()
    # the JAX runner's main writes this file from the same dict
    assert json.dumps({k: float(v) for k, v in heads["jax"].items()}, indent=1) == open(
        str(root / "port" / f"stage4_{ranker}" / "mAP_headline.json")).read()
    # near-GT hypotheses: every class present in the GT at ~100 10deg5cm mAP
    tables = _load(os.path.join(td, "mAP_Acc.pkl"))
    gt = _load(os.path.join(str(root / "port" / f"stage4_{ranker}"), "results_with_energy.pkl"))
    present = sorted({int(c) for e in gt.values() for c in e["result"]["gt_class_ids"]})
    d10, s05 = tables["degree_thres_list"].index(10), tables["shift_thres_list"].index(5)
    assert present and tables["pose_aps"][present, d10, s05].mean() >= 0.99


def test_main_writes_every_file_on_the_cpu(tree, tmp_path, monkeypatch):
    """``main`` through the port's flags on ``--device cpu``, with a port
    checkpoint for the score agent (``results/ckpts/<dir>``, as the JAX
    runner looks for its own) and seeded weights for the energy agent."""
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import save_checkpoint

    root, nocs = tree
    monkeypatch.chdir(tmp_path)
    argv = ["--data_path", nocs, "--result_dir", str(tmp_path / "res"), "--device", "cpu",
            "--score_model_dir", "score"] + FLAGS
    agent = PoseAgent(get_config(argv), "score", device="cpu")
    save_checkpoint("results/ckpts/score", agent, epoch=3)
    shutil.copytree(str(root / "port" / "mrcnn_results"), str(tmp_path / "res" / "mrcnn_results"))
    headline = tev.main(argv)
    base = tmp_path / "res" / "evaluation_results"
    inf = base / "real_test_repeat_3"
    for f in (base / "segmentation_results_real_test.pkl", base / "segmentation_logs_real_test.txt",
              inf / "results_wo_energy.pkl", inf / "cls_data.pkl",
              inf / "results_with_energy.pkl", inf / "mAP_headline.json",
              inf / "results" / "average" / "energy_ranker" / "mAP_Acc.pkl",
              inf / "results" / "average" / "energy_ranker" / "eval_logs.txt"):
        assert f.exists(), f
    assert set(headline) == {"5d2cm", "5d5cm", "10d2cm", "10d5cm"}
    assert json.load(open(inf / "mAP_headline.json")) == {k: float(v) for k, v in headline.items()}


def test_runner_device_never_falls_back_to_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("tpu", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tev.runner_device(get_config(["--device", name]))
    assert tev.runner_device(get_config(["--device", "cpu"])).type == "cpu"


BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, json, pickle, sys
    BLOCK = ("cv2", "PIL", "matplotlib")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCK:
                raise ImportError(f"{name} is blocked")

    for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
        del sys.modules[m]
    sys.meta_path.insert(0, Block())
    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.runners import evaluation_single as ev, evaluation_tracking
    cfg = get_config(sys.argv[1:])
    path = ev.detect_mrcnn_genpose(cfg, cfg.result_dir + "/seg.pkl")
    data = pickle.load(open(path, "rb"))
    print(json.dumps({"instances": sum(len(e["valid_pts"]) for e in data.values()),
                      "loaded": sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)}))
""")


def test_stage1_runs_with_cv2_pil_and_matplotlib_blocked(tree, tmp_path, stages):
    """Both runners import, and stage 1 writes the same cache, in a process
    where importing cv2, PIL or matplotlib raises."""
    root, nocs = tree
    res = tmp_path / "res"
    shutil.copytree(str(root / "port" / "mrcnn_results"), str(res / "mrcnn_results"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, "--data_path", nocs,
                          "--result_dir", str(res)] + FLAGS,
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["loaded"] == [] and report["instances"] >= 3
    want = _load(stages["port"]["seg"])
    got = _load(str(res / "seg.pkl"))
    for (kw, ew), eg in zip(want.items(), got.values()):
        _assert_equal(ew, eg, kw)
