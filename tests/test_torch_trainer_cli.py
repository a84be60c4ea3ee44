"""The port's training CLI (``genpose_tpu_torch.runners.trainer.main``) on the CPU.

- Every flow of the JAX ``trainer.main`` on a small synthetic NOCS tree
  (N=128, bs=4, 8 sampling steps, 1-2 epochs) with each flow's files:
  score training, its resume under ``--use_pretrain`` (the clock advances
  one epoch from the saved one), the energy warm start from score weights
  (tail outputs re-zeroed), distillation, energy_with_ranking, ``--eval``,
  ``--results_path`` (never over its input), ``--pred`` and
  ``--likelihood``; the missing ``--model_name`` error; the error of
  ``--num_devices`` beyond the machine's cards, the default's spawned
  workers on two cards against ``--num_devices 1``'s one process, and the
  flows that train nothing on rank 0 alone under ``torchrun``
  (``--save_video`` and the drawing are held in
  ``tests/test_torch_visualize.py``).
- Against the JAX package: ``evaluation`` of one shared ``results.pkl``
  within 1e-5 (the same float32 quaternion averaging; eigen-solver and
  arccos rounding), and one ``inference`` batch with the same weights
  (``from_jax_variables``) and the same prior rows pinned on both sides
  (``tests/_torch_parity.py``), rotation and translation errors and poses
  within rtol = atol = 1e-4, the tolerance of ``tests/test_torch_serving.py``.
"""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from genpose_tpu.config import Config as JaxConfig
from genpose_tpu.config import get_config as jax_get_config
from genpose_tpu.data.loader import get_data_loaders_from_cfg as jax_loaders
from genpose_tpu.runners import trainer as jtrainer
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.config import get_config as torch_get_config
from genpose_tpu_torch.data.synthetic import make_synthetic_nocs_dir
from genpose_tpu_torch.runners import trainer
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import load_clock, save_checkpoint
from genpose_tpu_torch.utils.weights import perturb_
from _torch_parity import jax_agent, pin_jax_prior, pin_port_prior, port_agent

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_serving.py's
EVAL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread while this module runs: the suite runs in
    several worker processes at once, and the training and sampling loops'
    many small ops slow down severely when every worker runs a thread per
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(tree, log_dir="run", *extra):
    return ["--data_path", tree, "--device", "cpu", "--batch_size", "4", "--mini_bs", "4",
            "--num_points", "128", "--repeat_num", "2", "--sampling_steps", "8",
            "--warmup", "2", "--num_workers", "2", "--log_dir", log_dir, *extra]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_nocs_dir(str(tmp_path_factory.mktemp("nocs") / "tree"),
                                   n_camera_scenes=8, n_real_scenes=2, seed=3)


@pytest.fixture(scope="module")
def score_run(tree, tmp_path_factory):
    """Two score epochs with an eval epoch after each, then one more by resume."""
    out = str(tmp_path_factory.mktemp("results"))
    trainer.main(["--agent_type", "score", "--n_epochs", "2", "--eval_freq", "1"]
                 + _flags(tree), out_dir=out)
    first = {"clock": load_clock(os.path.join(out, "ckpts", "run")),
             "ckpts": sorted(os.listdir(os.path.join(out, "ckpts", "run")))}
    trainer.main(["--agent_type", "score", "--n_epochs", "3", "--eval_freq", "1",
                  "--use_pretrain", "true"] + _flags(tree), out_dir=out)
    return out, first


def _tags(out, log_dir):
    with open(os.path.join(out, "logs", log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert all(np.isfinite(r["value"]) for r in rows)
    return {r["tag"] for r in rows}


def test_score_training_and_resume(score_run):
    out, first = score_run
    ckpt_dir = os.path.join(out, "ckpts", "run")
    assert first["ckpts"] == ["ckpt_epoch2", "ckpt_epoch3", "clock.json"]
    # 8 CAMERA scenes + the Real ones resampled: 2 full batches of 4 an epoch
    assert first["clock"] == {"epoch": 3, "minibatch": 0, "step": 4}
    assert load_clock(ckpt_dir) == {"epoch": 4, "minibatch": 0, "step": 6}  # one epoch more
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_epoch2", "ckpt_epoch3", "ckpt_epoch4",
                                            "clock.json"]
    assert {"epoch_time_s", "train/ode_mean_rot_error", "val/ode_mean_trans_error",
            "train/ema"} <= _tags(out, "run")


def _spy_train_energy(monkeypatch):
    """Record what ``main`` hands ``trainer.train_energy`` (with a copy of
    the energy agent's weights at that moment) and run it."""
    seen = {}
    orig = trainer.train_energy

    def spy(cfg, train_loader, val_loader, agent, score_agent=None, ranking=False, **kwargs):
        seen.update(agent=agent, teacher=score_agent, ranking=ranking,
                    state={k: v.clone() for k, v in agent.model.state_dict().items()},
                    shadow=agent.state.ema.shadow)
        return orig(cfg, train_loader, val_loader, agent, score_agent, ranking, **kwargs)

    monkeypatch.setattr(trainer, "train_energy", spy)
    return seen


def _ckpt_model(path):
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


def _is_tail_output(key):
    return key.endswith(("out_kernel", "out_bias", ".out.weight", ".out.bias"))


def test_energy_warm_start_rezeroes_the_heads(tree, score_run, monkeypatch):
    out, _ = score_run
    score_ckpt = os.path.join(out, "ckpts", "run", "ckpt_epoch4")
    seen = _spy_train_energy(monkeypatch)
    trainer.main(["--agent_type", "energy", "--pretrained_score_model_path", score_ckpt,
                  "--n_epochs", "1", "--eval_freq", "1"] + _flags(tree, "warm"), out_dir=out)
    want = _ckpt_model(score_ckpt)
    tails = [k for k in want if _is_tail_output(k)]
    assert tails and seen["shadow"] is None
    for k, v in seen["state"].items():
        if _is_tail_output(k):
            assert not v.any(), k
        else:
            assert torch.equal(v, want[k]), k
    assert seen["teacher"] is None and seen["ranking"] is False
    assert os.path.exists(os.path.join(out, "ckpts", "warm", "ckpt_epoch2"))
    assert "train/ode_mean_rot_error" in _tags(out, "warm")


def test_energy_distillation_has_a_score_teacher(tree, score_run, monkeypatch):
    out, _ = score_run
    score_ckpt = os.path.join(out, "ckpts", "run", "ckpt_epoch4")
    seen = _spy_train_energy(monkeypatch)
    trainer.main(["--agent_type", "energy", "--pretrained_score_model_path", score_ckpt,
                  "--distillation", "true", "--n_epochs", "1"] + _flags(tree, "distill"),
                 out_dir=out)
    teacher, ranking = seen["teacher"], seen["ranking"]
    assert teacher.mode == "score" and ranking is False and teacher.state.step == 0
    want = _ckpt_model(score_ckpt)
    for k, v in teacher.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert seen["agent"].state.step == 2
    assert os.path.exists(os.path.join(out, "ckpts", "distill", "ckpt_epoch2"))


def test_energy_with_ranking(tree, score_run, monkeypatch):
    out, _ = score_run
    score_ckpt = os.path.join(out, "ckpts", "run", "ckpt_epoch4")
    seen = _spy_train_energy(monkeypatch)
    trainer.main(["--agent_type", "energy_with_ranking", "--pretrained_score_model_path",
                  score_ckpt, "--n_epochs", "1"] + _flags(tree, "rank"), out_dir=out)
    teacher, ranking = seen["teacher"], seen["ranking"]
    assert teacher.mode == "score" and ranking is True and seen["agent"].mode == "energy"
    assert seen["agent"].state.step == 2 and teacher.state.step == 0
    assert load_clock(os.path.join(out, "ckpts", "rank")) == {"epoch": 2, "minibatch": 0,
                                                             "step": 2}
    with pytest.raises(ValueError, match="requires --pretrained_score_model_path"):
        trainer.main(["--agent_type", "energy_with_ranking"] + _flags(tree, "rank2"),
                     out_dir=out)


def test_eval_results_path_pred_and_likelihood(tree, score_run):
    """Each inference flow reads the run's newest checkpoint and writes its files."""
    out, _ = score_run
    flags = _flags(tree, "run", "--max_eval_num", "0")
    trainer.main(["--agent_type", "score", "--eval", "true"] + flags, out_dir=out)
    res_dir = os.path.join(out, "inference_results", "run", "Real_ode_8")
    with open(os.path.join(res_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(res_dir, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    assert sorted(metrics) == ["index_0", "index_1"]  # repeat_num
    n = results["gt_pose"].shape[0]
    assert results["pred_pose"].shape == (n, 2, 9) and n == 2  # the 2 Real test scenes
    assert np.isfinite(results["pred_pose"]).all()

    before = open(os.path.join(res_dir, "results.pkl"), "rb").read()
    trainer.main(["--results_path", os.path.join(res_dir, "results.pkl")] + flags, out_dir=out)
    with open(os.path.join(res_dir, "average_results.pkl"), "rb") as f:
        assert pickle.load(f).shape == (n, 2)
    assert open(os.path.join(res_dir, "results.pkl"), "rb").read() == before

    trainer.main(["--agent_type", "score", "--pred", "true"] + flags, out_dir=out)
    with open(os.path.join(out, "predictions", "run", "prediction_results.pkl"), "rb") as f:
        pred = pickle.load(f)
    assert len(pred) == 1 and pred[0]["pred_pose"].shape == (n, 2, 7)
    assert not pred[0]["energy"].any()  # a score-only run has no ranking signal

    trainer.main(["--agent_type", "score", "--likelihood", "true"] + flags, out_dir=out)
    with open(os.path.join(out, "inference_results", "run", "Real_likelihood",
                           "likelihood.json")) as f:
        summary = json.load(f)
    assert summary["n"] == n and np.isfinite(summary["mean_bits"])


def test_pred_ranks_by_the_energy_agent(tree, score_run):
    """--pred of an energy_with_ranking run: the score checkpoint samples,
    the energy checkpoint (--pretrained_energy_model_path) ranks."""
    out, _ = score_run
    score_ckpt = os.path.join(out, "ckpts", "run", "ckpt_epoch4")
    energy = PoseAgent(torch_get_config(_flags(tree)), "energy", device="cpu")
    perturb_(energy.model, seed=3)  # non-zero tails: the seeded ones give zero energies
    energy_ckpt = save_checkpoint(os.path.join(out, "ckpts", "perturbed"), energy, 1)
    trainer.main(["--agent_type", "energy_with_ranking", "--pretrained_score_model_path",
                  score_ckpt, "--pretrained_energy_model_path", energy_ckpt, "--pred", "true"]
                 + _flags(tree, "pred_e", "--max_eval_num", "0"), out_dir=out)
    with open(os.path.join(out, "predictions", "pred_e", "prediction_results.pkl"), "rb") as f:
        pred = pickle.load(f)[0]
    assert pred["energy"].shape == pred["pred_pose"].shape[:2] + (2,) and pred["energy"].any()
    assert pred["choosed_pred_pose"].shape == pred["average_pred_pose"].shape


def test_results_path_never_overwrites_its_input(tmp_path):
    """A results file whose name holds no ``results.pkl`` gets
    ``<name>.average_results.pkl`` beside it."""
    path = tmp_path / "results_with_energy.pickle"
    results = _results(np.random.default_rng(0), 3, 2)
    with open(path, "wb") as f:
        pickle.dump(results, f)
    trainer.evaluation(TorchConfig(results_path=str(path)), device="cpu")
    with open(path, "rb") as f:
        assert pickle.load(f).keys() == results.keys()
    assert os.path.exists(str(path) + ".average_results.pkl")


def test_missing_model_name_fails_loudly(tree, tmp_path):
    with pytest.raises(FileNotFoundError, match="--model_name 77"):
        trainer.main(["--agent_type", "score", "--eval", "true", "--model_name", "77"]
                     + _flags(tree, "none"), out_dir=str(tmp_path))


@pytest.mark.parametrize("flags,match", [(["--num_devices", "2"], "several cards")])
def test_unported_options_raise_before_any_work(tmp_path, flags, match):
    """Training on more cards than the machine has raises before any work
    (``--num_devices 2`` on the card; several CPU processes are
    ``tests/test_torch_parallel.py``'s)."""
    missing = str(tmp_path / "no_tree")  # never read: the refusal comes first
    with pytest.raises(RuntimeError, match=match):
        trainer.main(["--agent_type", "score"] + flags + _flags(missing) + ["--device", "cuda"],
                     out_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flags,spawned", [([], 2), (["--num_devices", "1"], None)])
def test_num_devices_on_a_machine_with_two_cards(tmp_path, monkeypatch, flags, spawned):
    """On two cards the default (0, every card) trains in two spawned
    workers; ``--num_devices 1`` trains in this process."""
    calls = []
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(trainer.parallel, "launch",
                        lambda fn, world, device, args=(): calls.append(("launch", world)))
    monkeypatch.setattr(trainer, "_main",
                        lambda cfg, device, group, out_dir: calls.append(("main", group)))
    trainer.main(["--agent_type", "score"] + flags + _flags(str(tmp_path / "no_tree"))
                 + ["--device", "cuda"], out_dir=str(tmp_path))
    assert calls == ([("launch", spawned)] if spawned else [("main", None)])


@pytest.mark.parametrize("flag", ["--eval", "--pred", "--likelihood", "--results_path"])
def test_flows_that_train_nothing_run_on_rank_0_alone(tmp_path, monkeypatch, flag):
    """Under ``torchrun`` a rank other than 0 returns from ``--eval``,
    ``--pred``, ``--likelihood`` and ``--results_path`` at once: no work,
    no files."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(trainer, "_main", lambda *a: pytest.fail("rank 1 ran the flow"))
    monkeypatch.setattr(trainer, "evaluation", lambda *a: pytest.fail("rank 1 evaluated"))
    value = str(tmp_path / "results.pkl") if flag == "--results_path" else "true"
    trainer.main(["--agent_type", "score", flag, value] + _flags(str(tmp_path / "no_tree")),
                 out_dir=str(tmp_path / "out"))
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _rot6d(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return q[..., :2].transpose(0, 2, 1).reshape(n, 6)  # the first two columns of R


def _results(rng, n, k):
    gt = np.concatenate([_rot6d(rng, n), rng.normal(size=(n, 3))], axis=1)
    pred = np.concatenate([_rot6d(rng, n * k).reshape(n, k, 6),
                           gt[:, None, 6:] + 0.05 * rng.normal(size=(n, k, 3))], axis=2)
    return {"pred_pose": pred.astype(np.float32), "gt_pose": gt.astype(np.float32),
            "cls_id": rng.integers(0, 6, n), "handle_visibility": rng.integers(0, 2, n)}


def test_evaluation_equals_jax(tmp_path):
    results = _results(np.random.default_rng(1), 12, 5)
    errors = {}
    for name, run, cfg in (("jax", jtrainer.evaluation, JaxConfig),
                           ("port", functools.partial(trainer.evaluation, device="cpu"),
                            TorchConfig)):
        path = tmp_path / name / "results.pkl"
        path.parent.mkdir()
        with open(path, "wb") as f:
            pickle.dump(results, f)
        returned = run(cfg(results_path=str(path)))
        with open(path.parent / "average_results.pkl", "rb") as f:
            errors[name] = pickle.load(f)
        np.testing.assert_array_equal(returned, errors[name])
    assert errors["port"].shape == (12, 2)
    np.testing.assert_allclose(errors["port"], errors["jax"], rtol=EVAL_TOL, atol=EVAL_TOL)


def test_inference_batch_equals_jax(tree, tmp_path, monkeypatch):
    """One test batch from the JAX loader through both packages' ``inference``:
    the JAX agent's EMA shadow as the port's weights, the prior rows pinned."""
    flags = ["--data_path", tree, "--num_points", "128", "--mini_bs", "4", "--repeat_num", "2",
             "--sampling_steps", "8", "--max_eval_num", "0", "--log_dir", "par"]
    jcfg = jax_get_config(flags)
    raw = next(iter(jax_loaders(jcfg, ["test"])["test_loader"]))
    bs = raw["pcl_in"].shape[0]
    noise = np.random.default_rng(4).normal(size=(bs, 9)).astype(np.float32)
    jagent = jax_agent(jcfg, "score", seed=5)
    pin_jax_prior(jagent, noise)
    monkeypatch.chdir(tmp_path)  # the JAX runner writes under ./results
    jpath = jtrainer.inference(jcfg, [raw], jagent)
    tcfg = torch_get_config(flags)
    tagent = port_agent(tcfg, "score", jagent, use_ema=True)
    pin_port_prior(tagent, noise)
    tpath = trainer.inference(tcfg, [raw], tagent, out_dir=str(tmp_path / "port"))
    assert os.path.relpath(tpath, tmp_path / "port") == os.path.relpath(jpath, "results")
    with open(jpath, "rb") as f:
        want = pickle.load(f)
    with open(tpath, "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want)
    for k in ("gt_pose", "cls_id", "handle_visibility"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["pred_pose"], want["pred_pose"], **TOL)
    metrics = [json.load(open(os.path.join(os.path.dirname(p), "metrics.json")))
               for p in (tpath, jpath)]
    for key in metrics[1]:
        np.testing.assert_allclose(metrics[0][key], metrics[1][key], err_msg=key, **TOL)
