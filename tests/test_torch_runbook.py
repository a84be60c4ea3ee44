"""genpose_tpu_torch/tools/real275_parity_runbook.sh on a synthetic NOCS tree.

The test lays out what the runbook expects under a run directory: two
released-layout ``.pth`` checkpoints (seeded, perturbed port models written
in the reference's torch layout by ``chip_smoke.py::upstream_state_dict``)
and the segmentation pkl (the port's stage 1 on the tree's fabricated
Mask R-CNN results).  The runbook then ports both checkpoints, runs the
port's evaluation at the released protocol (K cut to 3, 64 points, 4 steps,
batch 4; the adaptive sampler, T0 0.55, energy ranker, average pooling)
on the CPU and compares the headline with a given row.  Without the
artifacts it stops with exit code 2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from genpose_tpu_torch.config import get_config
from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results, make_synthetic_nocs_dir
from genpose_tpu_torch.runners import evaluation_single as tev
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils.weights import perturb_, to_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import upstream_state_dict  # noqa: E402

RUNBOOK = os.path.join(ROOT, "genpose_tpu_torch", "tools", "real275_parity_runbook.sh")


def _run(env_extra):
    # one thread a process: the tier-1 run has other workers on the same cores
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **env_extra)
    return subprocess.run(["bash", RUNBOOK], env=env, capture_output=True, text=True,
                          timeout=600)


def test_runbook_without_artifacts_stops(tmp_path):
    res = _run({"RUN_DIR": str(tmp_path)})
    assert res.returncode == 2
    assert "MISSING: results/ckpts/ScoreNet/ckpt_genpose.pth" in res.stdout


def test_runbook_on_a_synthetic_tree(tmp_path):
    run = tmp_path / "run"
    tree = make_synthetic_nocs_dir(str(tmp_path / "nocs"), n_camera_scenes=1, n_real_scenes=2,
                                   seed=5)
    results = run / "results"
    make_synthetic_mrcnn_results(tree, str(results), "real_test")
    cfg = get_config(["--data_path", tree, "--result_dir", str(results), "--num_points", "64",
                      "--test_source", "real_test"])
    tev.detect_mrcnn_results(cfg, str(results / "evaluation_results" /
                                      "segmentation_results_real_test.pkl"))
    for mode, name, seed in (("score", "ScoreNet", 1), ("energy", "EnergyNet", 2)):
        agent = PoseAgent(cfg, mode, device="cpu")
        perturb_(agent.model, seed=seed)
        path = results / "ckpts" / name / "ckpt_genpose.pth"
        path.parent.mkdir(parents=True)
        torch.save({"model_state_dict": upstream_state_dict(*to_jax_variables(agent.model)),
                    "clock": {"epoch": 1, "minibatch": 0, "step": 10}}, path)
    zeros = {"5d2cm": 0.0, "5d5cm": 0.0, "10d2cm": 0.0, "10d5cm": 0.0}
    res = _run({"RUN_DIR": str(run), "DEVICE": "cpu", "NOCS_DATASET_PATH": tree,
                "EVAL_REPEAT": "3", "BATCH_SIZE": "4",
                "EVAL_FLAGS": "--num_points 64 --sampling_steps 4",
                "PORT_FLAGS": "--num_points 64", "PAPER_ROW": json.dumps(zeros)})
    assert res.returncode == 0, res.stdout + res.stderr
    for stage in ("stage 1/3", "stage 2/3", "stage 3/3"):
        assert stage in res.stdout
    for name in ("ScoreNet", "EnergyNet"):
        assert (results / "ckpts" / name / "ckpt_genpose_ported" / "ckpt_epoch1").exists()
    headline = json.load(open(results / "evaluation_results" / "real_test_repeat_3" /
                              "mAP_headline.json"))
    assert set(headline) == set(zeros)
    # untrained weights: mAP 0 at every threshold, so the zero row passes
    assert all(np.isclose(v, 0.0) for v in headline.values())
    assert "PARITY: PASS" in res.stdout
    table = res.stdout[res.stdout.index("stage 3/3"):]
    assert "   5d2cm     0.0     0.0    +0.0" in table
