"""Data parallelism in genpose_tpu_torch (``parallel/``) on the CPU: two gloo
processes against one process and against the JAX package's ``make_mesh(2)``.

The same numpy-seeded batch, weights carried across from the JAX agents
(``from_jax_train_state``) and the JAX draws of each step handed to both
(each rank its own rows of them).  Sizes: 64 points, a global batch of 4
(2 rows a rank), 2 DSM draws, 4 sampler steps, K=3.

- (a) two score steps (SGD, warmup 2: lr 0, then 5e-4): losses at rtol
  1e-4, parameters at rtol 1e-4 / atol 1e-6 and BatchNorm running
  statistics at rtol 1e-4 / atol 1e-5, against one process and against
  the JAX mesh; also with the draws made by a generator (the global
  batch's, each rank keeping its rows).  The running means' atol is
  float32 noise: a channel's batch mean summed in another order moves by
  ~1e-6 where its entries are of order 1 (1.4e-6 measured).  One process,
  and a group of one, which is the same program bit for bit, train
  through ``nn.BatchNorm1d``, whose CPU statistics accumulate in float32
  row by row: over 32,768-65,536 rows a channel with one thread that
  moves a train-mode layer's output further from the float64 result than
  two-pass float32 sums do, and the first loss beyond the losses' rtol
  1e-4 from the group's and the JAX mesh's.  So training is held against
  one process
  whose train-mode BatchNorm takes the two-pass statistics of a group
  (``global_batch_norm`` over a group of one); the served results, in
  eval mode, against one process and that reference both;
- (b) two energy-with-ranking steps: ``gf`` and ``ranking`` at rtol 1e-4;
- (c) ``InferencePipeline.predict`` under the group (6 clouds: a full chunk
  and a padded one) under Heun and RK45, against the JAX mesh pipeline with
  the prior rows pinned and against one process with the prior drawn:
  rtol = atol = 2e-4, pooled quaternions up to sign; the group's frozen
  programs equal its eager pipeline bit for bit; the control, RK45 with
  each rank's own error norm, must fail that comparison;
- (d) ``trainer.main --num_devices 2 --device cpu``: an epoch, a resume,
  rank 0 alone writing the checkpoints and logs, the state within rtol 1e-3
  / atol 1e-4 of ``trainer.main`` run in a group of one with the two-pass
  BatchNorm statistics of (a)'s reference (SGD, as
  ``tests/test_torch_training.py``'s trajectories: Adam's first steps move
  each parameter by about its learning rate whatever the gradient's size,
  so a near-zero gradient's float noise flips a whole step);
- (e) ``evaluation_single.main`` on two ranks: the pickled hypotheses and
  energies within 2e-4 of one rank's, the mAP tables identical;
- (f) ``dryrun_multidevice(2, "cpu")``;
- a rank that raises fails the whole run.
"""

import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.config import Config
from genpose_tpu.data.process import process_batch as jax_process_batch
from genpose_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from genpose_tpu.parallel.mesh import make_mesh, shard_batch
from genpose_tpu.runners.serving import InferencePipeline as JaxPipeline
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results, make_synthetic_nocs_dir
from genpose_tpu_torch.parallel import group as parallel
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.training.checkpoints import save_checkpoint
from genpose_tpu_torch.utils.weights import from_jax_train_state, from_jax_variables, perturb_
from _torch_parallel_workers import rank1_raises, run_group, two_pass_batch_norm
from _torch_parity import derandomize_agent, dsm_noise, pin_jax_prior, train_agent

N_PTS, BS, REPEAT, K, STEPS = 64, 4, 2, 3, 4
LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)  # BatchNorm running statistics (module docstring)
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)
TRAIN = dict(num_points=N_PTS, batch_size=BS, repeat_num=REPEAT, warmup=2, lr=1e-3,
             optimizer="SGD", eval_repeat_num=K, sampling_steps=STEPS, T0=0.55)


def _port_ckpt(jax_state, mode, path):
    agent = PoseAgent(TorchConfig(**TRAIN), mode, device="cpu")
    from_jax_train_state(jax.device_get(jax_state), agent)
    return save_checkpoint(path, agent, epoch=0)


def _shadow_w_from_params(agent):
    """The EMA shadow's Fourier ``W`` made the params' (the port keeps ``W``
    as a buffer; a trained shadow never moves it)."""
    st = agent.state
    shadow = jax.tree_util.tree_map(lambda x: x, st.ema.shadow)
    shadow["head"]["trunk"]["t_fourier"]["W"] = st.params["head"]["trunk"]["t_fourier"]["W"]
    agent.state = st.replace(ema=st.ema.replace(shadow=shadow))


def _jax_batch():
    raw = jax_synthetic_batch(np.random.default_rng(5), bs=BS, n_pts=N_PTS, n_model=256)
    raw["cat_id"] = np.array([1, 5, 0, 2], np.int32)
    raw["handle_visibility"] = np.array([1, 0, 1, 1], np.int32)
    return {k: np.asarray(v) for k, v in jax_process_batch(raw).items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread here and in every spawned rank (``launch`` shares
    the parent's threads out): the tier-1 run has other workers on the
    same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh's steps and pipelines, and the port's on 2 ranks, on one
    process and on one process with a group's two-pass BatchNorm statistics."""
    tmp = tmp_path_factory.mktemp("parallel")
    mesh = make_mesh(2)
    jcfg = Config(gather_fwd="exact", gather_grad="exact", **TRAIN)
    js = train_agent(jcfg, "score", seed=1, mesh=mesh)
    je = train_agent(jcfg, "energy", seed=2, mesh=mesh)
    ckpt = {"score": _port_ckpt(js.state, "score", str(tmp / "score")),
            "energy": _port_ckpt(je.state, "energy", str(tmp / "energy"))}
    batch = _jax_batch()
    jbatch = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(7)
    want = {"score": [], "energy": []}
    spec = {"dsm_noise": [], "cands": [], "t_int": []}
    for _ in range(2):
        key, k = jax.random.split(key)
        want["score"].append(float(js.train_step(jbatch, k)["gf"]))
        spec["dsm_noise"].append(tuple(x.numpy() for x in dsm_noise(k, js.sde.eps, REPEAT, BS)))
        cands = rng.normal(size=(BS, K, 9)).astype(np.float32) * 0.3
        cands[..., -3:] = batch["gt_pose"][:, None, -3:] + 0.05 * cands[..., -3:]
        key, k = jax.random.split(key)
        k_dsm, k_t = jax.random.split(k)
        step = je.train_step_energy(jbatch, shard_batch(mesh, jnp.asarray(cands)), k)
        want["energy"].append([float(step["gf"]), float(step["ranking"])])
        spec["cands"].append(cands)
        spec["t_int"].append(np.asarray(jax.random.randint(k_t, (BS, 1), 1, 10)))
        spec.setdefault("energy_noise", []).append(
            tuple(x.numpy() for x in dsm_noise(k_dsm, je.sde.eps, REPEAT, BS)))
    want["score_state"] = jax.device_get(js.state)
    want["energy_state"] = jax.device_get(je.state)

    prior = np.random.default_rng(0).normal(size=(BS * K, 9)).astype(np.float32)
    pts = np.random.default_rng(6).normal(size=(6, N_PTS, 3)).astype(np.float32) * 0.1
    pts += np.random.default_rng(7).normal(size=(6, 1, 3)).astype(np.float32)
    for sampler in ("ode", "ode_adaptive"):
        jp = JaxPipeline(Config(**dict(TRAIN, sampler_mode=(sampler,))), batch_size=BS,
                         mesh=mesh)
        for agent, seed in ((jp.score_agent, 3), (jp.energy_agent, 4)):
            derandomize_agent(agent, seed)
            _shadow_w_from_params(agent)
        pin_jax_prior(jp.score_agent, prior)
        want[f"serve_{sampler}"] = jp.predict(pts, key=jax.random.PRNGKey(0))
        if sampler == "ode":
            ckpt["serve_score"] = _port_ckpt(jp.score_agent.state, "score", str(tmp / "ss"))
            ckpt["serve_energy"] = _port_ckpt(jp.energy_agent.state, "energy", str(tmp / "se"))
    spec.update(cfg=TRAIN, ckpt=ckpt, batch=batch, prior=prior, pts=pts)
    plain = run_group(None, spec)
    group = parallel.make_group(1, "cpu")  # a group of one, in this process
    try:  # with the statistics of a group's BatchNorm (module docstring)
        one = run_group(group, dict(spec, two_pass_batch_norm=True))
    finally:
        parallel.destroy_group()
    two = parallel.launch(run_group, 2, "cpu", args=(spec,))
    return want, dict(one, plain=plain), two


def _assert_state(got, want, what, tol=None):
    for k, v in want.items():
        if "num_batches" in k:
            continue
        k_tol = tol or (STATS_TOL if "running" in k else PARAM_TOL)
        np.testing.assert_allclose(got[k], v, err_msg=f"{what}: {k}", **k_tol)


def _jax_state(st):
    return {k: v.numpy() for k, v in from_jax_variables(st.params, st.batch_stats).items()}


def _assert_served(got, want):
    for k in ("best_pose", "sorted_hypotheses", "energy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SERVE_TOL)
    q, wq = got["pred_pose"][:, :4], want["pred_pose"][:, :4]
    sign = np.sign(np.sum(q * wq, axis=1, keepdims=True))
    np.testing.assert_allclose(q * sign, wq, err_msg="pred_pose q", **SERVE_TOL)
    np.testing.assert_allclose(got["pred_pose"][:, 4:], want["pred_pose"][:, 4:],
                               err_msg="pred_pose t", **SERVE_TOL)


def test_ranks_agree(runs):
    """Every rank returns the same losses, states and gathered predictions."""
    _, _, two = runs
    for k, v in two[0].items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(two[1][k][kk], v[kk], err_msg=f"{k}/{kk}")
        else:
            np.testing.assert_array_equal(two[1][k], v, err_msg=k)


@pytest.mark.parametrize("draws", ["jax", "gen"])
def test_score_steps_match_one_process_and_the_jax_mesh(runs, draws):
    want, one, two = runs
    got = two[0]
    np.testing.assert_allclose(got[f"score_{draws}_losses"], one[f"score_{draws}_losses"],
                               **LOSS_TOL)
    _assert_state(got[f"score_{draws}_state"], one[f"score_{draws}_state"],
                  "one process, two-pass BatchNorm")
    if draws == "jax":
        np.testing.assert_allclose(got["score_jax_losses"], want["score"], **LOSS_TOL)
        _assert_state(got["score_jax_state"], _jax_state(want["score_state"]), "JAX mesh")


def test_energy_steps_match_one_process_and_the_jax_mesh(runs):
    want, one, two = runs
    got = two[0]
    for ref in (want["energy"], one["energy_losses"]):
        np.testing.assert_allclose(got["energy_losses"], ref, **LOSS_TOL)
    _assert_state(got["energy_state"], one["energy_state"], "one process, two-pass BatchNorm")


@pytest.mark.parametrize("sampler", ["ode", "ode_adaptive"])
def test_pipeline_matches_one_process_and_the_jax_mesh(runs, sampler):
    want, one, two = runs
    got = two[0]
    assert got[f"serve_{sampler}_pinned"]["pred_pose"].shape == (6, 7)
    _assert_served(got[f"serve_{sampler}_pinned"], want[f"serve_{sampler}"])
    for ref in (one, one["plain"]):
        _assert_served(got[f"serve_{sampler}_drawn"], ref[f"serve_{sampler}_drawn"])
        _assert_served(ref[f"serve_{sampler}_pinned"], want[f"serve_{sampler}"])
    # frozen under the group = eager under the group, bit for bit (on the CPU)
    for k, v in got[f"serve_{sampler}_pinned"].items():
        np.testing.assert_array_equal(got[f"serve_{sampler}_frozen"][k], v, err_msg=k)


def test_rk45_with_each_ranks_own_norm_fails_the_comparison(runs):
    """The control: RK45 whose error norm covers only the rank's rows picks
    other step sizes than the global batch's, and the comparison above sees it."""
    want, _, two = runs
    with pytest.raises(AssertionError):
        _assert_served(two[0]["serve_rk45_per_rank_norm"], want["serve_ode_adaptive"])


def _trainer_flags(tree, log, *extra):
    return ["--data_path", tree, "--device", "cpu", "--batch_size", "4", "--mini_bs", "4",
            "--num_points", "64", "--repeat_num", "2", "--sampling_steps", "4",
            "--warmup", "2", "--num_workers", "1", "--optimizer", "SGD", "--log_dir", log,
            *extra]


@pytest.fixture(scope="module")
def nocs_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nocs_parallel")
    tree = make_synthetic_nocs_dir(str(root / "tree"), n_camera_scenes=4, n_real_scenes=2,
                                   seed=3)
    make_synthetic_mrcnn_results(tree, str(root / "res"), "real_test")
    return root, tree


def test_trainer_cli_on_two_ranks_with_resume(nocs_tree, tmp_path):
    from genpose_tpu_torch.runners import trainer

    _, tree = nocs_tree
    outs = {}
    for n in ("1", "2"):
        out = str(tmp_path / f"w{n}")
        for argv in (["--n_epochs", "1"], ["--n_epochs", "2", "--use_pretrain", "true"]):
            argv = ["--agent_type", "score", "--eval_freq", "1", "--num_devices", n, *argv]
            if n == "1":  # main joins the group of one made here, as under torchrun
                group = parallel.make_group(1, "cpu")
                try:  # with a group's BatchNorm statistics, as (a)'s reference
                    with two_pass_batch_norm(group):
                        trainer.main(argv + _trainer_flags(tree, "run"), out_dir=out)
                finally:
                    parallel.destroy_group()
            else:
                trainer.main(argv + _trainer_flags(tree, "run"), out_dir=out)
        outs[n] = out
    ckdir = os.path.join(outs["2"], "ckpts", "run")
    one_dir = os.path.join(outs["1"], "ckpts", "run")
    assert sorted(os.listdir(ckdir)) == sorted(os.listdir(one_dir)) == [
        "ckpt_epoch2", "ckpt_epoch3", "clock.json"]
    assert json.load(open(os.path.join(ckdir, "clock.json"))) == \
        json.load(open(os.path.join(one_dir, "clock.json")))
    # one writer: every logged (tag, step) once, as one process logs them
    logs = {}
    for n, out in outs.items():
        with open(os.path.join(out, "logs", "run", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        keys = [(r["tag"], r["step"]) for r in rows]
        assert len(keys) == len(set(keys)), n
        logs[n] = {k: r["value"] for k, r in zip(keys, rows)}
    assert logs["1"].keys() == logs["2"].keys()
    for k, v in logs["1"].items():
        if "time" not in k[0]:
            np.testing.assert_allclose(logs["2"][k], v, rtol=1e-3, err_msg=str(k))
    a = torch.load(os.path.join(one_dir, "ckpt_epoch3"), weights_only=True)
    b = torch.load(os.path.join(ckdir, "ckpt_epoch3"), weights_only=True)
    assert a["step"] == b["step"]
    for k, v in a["model"].items():
        np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def _eval_argv(root, tree, out, n):
    return ["--data_path", tree, "--result_dir", str(out), "--device", "cpu",
            "--score_model_dir", "score", "--energy_model_dir", "energy",
            "--test_source", "real_test", "--num_points", "64", "--eval_repeat_num", "3",
            "--sampling_steps", "4", "--T0", "0.55", "--batch_size", "4",
            "--pooling_mode", "average", "--eval_ratios", "0.6", "--num_devices", n]


def test_evaluation_single_on_two_ranks(nocs_tree, tmp_path, monkeypatch):
    from genpose_tpu_torch.runners import evaluation_single as tev

    root, tree = nocs_tree
    monkeypatch.chdir(tmp_path)
    cfg = tev.get_config(_eval_argv(root, tree, tmp_path, "1"))
    for mode, seed in (("score", 1), ("energy", 2)):
        agent = PoseAgent(cfg, mode, device="cpu")
        perturb_(agent.model, seed=seed)
        save_checkpoint(f"results/ckpts/{mode}", agent, epoch=0)
    res = {}
    for n in ("1", "2"):
        out = tmp_path / f"w{n}"
        shutil.copytree(str(root / "res" / "mrcnn_results"), str(out / "mrcnn_results"))
        headline = tev.main(_eval_argv(root, tree, out, n))
        assert set(headline) == {"5d2cm", "5d5cm", "10d2cm", "10d5cm"}
        inf = out / "evaluation_results" / "real_test_repeat_3"
        with open(inf / "results_with_energy.pkl", "rb") as f:
            res[n] = {"pkl": pickle.load(f), "headline": headline}
        with open(inf / "results" / "average" / "energy_ranker" / "mAP_Acc.pkl", "rb") as f:
            res[n]["tables"] = pickle.load(f)
    assert res["2"]["headline"] == res["1"]["headline"]
    for a, b in zip(res["1"]["tables"], res["2"]["tables"]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert res["1"]["pkl"].keys() == res["2"]["pkl"].keys()
    for path, entry in res["1"]["pkl"].items():
        for key in ("multi_hypothesis_pred_RTs", "energy"):
            np.testing.assert_allclose(res["2"]["pkl"][path]["result"][key],
                                       entry["result"][key], err_msg=f"{path} {key}",
                                       **SERVE_TOL)


def test_dryrun_multidevice_on_two_cpu_ranks():
    from genpose_tpu_torch.tools.dryrun_multi import dryrun_multidevice

    out = dryrun_multidevice(2, "cpu")
    assert out["world"] == 2 and out["serving_pred"] == (4, 7)
    assert all(np.isfinite(out[k]) for k in ("score_loss", "resumed_loss", "energy_loss",
                                             "ranking_loss"))


def test_a_failing_rank_fails_the_whole_run():
    """Rank 1 raises while rank 0 waits in a barrier: the run ends with an
    error (rank 1's, or rank 0's lost connection, whichever the parent sees
    first) instead of a rank going on alone or hanging."""
    import torch.multiprocessing as mp

    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException),
                       match="rank 1 fails|Connection|terminated"):
        parallel.launch(rank1_raises, 2, "cpu")


def test_helpers_are_the_identity_without_a_group():
    x = torch.arange(12.0).reshape(6, 2)
    assert parallel.shard_batch(None, x) is x
    assert parallel.all_gather_rows(None, x) is x
    assert parallel.pad_to_multiple(5, 2) == 6 and parallel.pad_to_multiple(6, 3) == 6
    assert parallel.active() is None
    g = torch.Generator().manual_seed(0)
    got = parallel.local_draw(lambda n: torch.randn((n, 3), generator=g), 4)
    np.testing.assert_array_equal(got, torch.randn((4, 3), generator=torch.Generator()
                                                   .manual_seed(0)))
    means = torch.tensor([2.0, 3.0])
    assert parallel.mean_over_rows_(means, 7) is means and means.tolist() == [2.0, 3.0]


def test_a_group_of_one_is_the_single_process():
    """At world 1 every helper is the identity and train-mode BatchNorm is
    ``nn.BatchNorm1d``: a score step under ``sharded`` of a group of one
    equals the step without a group bit for bit."""
    from genpose_tpu_torch.data.process import process_batch
    from genpose_tpu_torch.data.synthetic import synthetic_batch
    from genpose_tpu_torch.models.layers import batch_norm

    cfg = TorchConfig(**TRAIN)
    batch = process_batch(synthetic_batch(np.random.default_rng(3), bs=BS, n_pts=N_PTS),
                          cfg.pose_mode, torch.Generator().manual_seed(1), cfg.pts_aug,
                          device="cpu")
    out = {}
    group = parallel.make_group(1, "cpu")
    try:
        for name, g in (("plain", None), ("group", group)):
            agent = PoseAgent(cfg, "score", device="cpu")
            perturb_(agent.model, seed=1)
            with parallel.sharded(g):
                loss = agent.train_step(batch, torch.Generator().manual_seed(2))["gf"]
                bn = torch.nn.BatchNorm1d(3)
                x = torch.randn((40, 3), generator=torch.Generator().manual_seed(4)) + 5
                out[name] = (loss, agent.model.state_dict(), batch_norm(bn, x),
                             bn.running_var.clone())
        grads = {"w": torch.ones(3)}
        assert parallel.average_gradients_(grads, group) is grads
        losses = {"gf": torch.tensor(1.5)}
        assert parallel.mean_over_ranks(losses, group) is losses
    finally:
        parallel.destroy_group()
    (la, sa, ya, va), (lb, sb, yb, vb) = out["plain"], out["group"]
    assert torch.equal(la, lb) and torch.equal(ya, yb) and torch.equal(va, vb)
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        assert torch.equal(sb[k], v), k


class _Visits:
    """A dataset whose samples are their (index, visit)."""

    def __len__(self):
        return 10

    def fetch(self, index, visit):
        return {"index": np.int64(index), "visit": np.int64(visit)}


def test_a_sharded_loader_yields_its_rows_of_each_global_batch():
    """Rank r's loader: the same permutation, drop_last and visit numbers as
    one loader over the global batch, rank r's contiguous block of each."""
    from genpose_tpu_torch.data.loader import DataLoader

    def epochs(shard):
        ld = DataLoader(_Visits(), batch_size=4, num_workers=1, drop_last=True, seed=3,
                        shard=shard)
        return [[{k: v.copy() for k, v in b.items()} for b in ld] for _ in range(2)]

    whole = epochs(None)
    ranks = [epochs((r, 2)) for r in range(2)]
    assert len(whole[0]) == 2  # 10 samples, drop_last: two batches of 4
    for e in range(2):
        for i, batch in enumerate(whole[e]):
            for k in ("index", "visit"):
                np.testing.assert_array_equal(
                    np.concatenate([ranks[r][e][i][k] for r in range(2)]), batch[k])
    with pytest.raises(ValueError, match="does not divide"):
        next(iter(DataLoader(_Visits(), batch_size=3, num_workers=1, shard=(0, 2))))
