"""Training convergence check: train the full-size score net on a synthetic
4-object task on the card and check that the DSM loss and the sampled pose
error fall (counterpart of ``tools/tpu_convergence_check.py``, which mirrors
``tests/test_convergence.py`` at the production model size).

The task: four fixed clouds ``rng.normal((4, 1024, 3)) * 0.1`` from
``np.random.default_rng(0)``; every batch draws, per row, one of the clouds,
a rotation (QR of a Gaussian matrix, signs fixed to a proper rotation), a
translation in [-0.2, 0.2] m and the 6-D pose (the first two columns of R)
with the translation.  The net is the released model (light PointNet++,
VE SDE, Rx_Ry_and_T heads) at N=1024 with 20 DSM draws a cloud, Adam at
``LR`` with a 100-step warm-up and 100 steps an epoch of the schedule.
Evaluation (``sampled_errors``): one held-out batch, one Heun ``ode``
sample of 100 steps per cloud from the EMA shadow, mean rotation error in
degrees and translation error in metres.

Two modes, as the JAX tool:

- fixed (``EVAL_EVERY=0``, the default): ``N_STEPS`` steps, then the DSM
  loss must have halved, the rotation error fallen below a third and the
  translation error below a twentieth of the untrained net's; prints
  ``CONVERGED OK``;
- criterion (``EVAL_EVERY=n``): evaluate every n steps and stop at the
  first evaluation with rotation below ``ROT_CRIT`` degrees and translation
  below ``TRANS_CRIT`` cm; prints the step and the training seconds (the
  evaluation pauses and the first step, which builds the kernels, left
  out) and exits 0 whether or not the criterion was met.

With ``--pair`` it then trains an energy net with the ranking loss
(``train_energy_ranking``, after ``tests/test_convergence.py::
test_energy_ranking_training_converges`` at full width), saves both agents
(``training/checkpoints.py``) and serves the trained pair frozen through
``runners/serving.py::InferencePipeline`` (``serve_trained``).
``chip_smoke.py`` phase 21 calls the same functions.

Environment knobs (the JAX tool's): ``TRAIN_BATCH`` (64), ``N_STEPS``
(3000), ``LR`` (1e-3), ``TRAIN_DTYPE`` (float32), ``HEAD_DTYPE``,
``BN_DTYPE``, ``GEOM_DTYPE`` (compute), ``F32_STAGES`` (0), ``EVAL_EVERY``
(0), ``ROT_CRIT`` (41.0), ``TRANS_CRIT`` (3.9).  ``GATHER_FWD`` and ``GATHER_GRAD`` are accepted and do nothing
on the GPU: they choose among TPU gather lowerings (``config.py``).

Usage (on the card unless ``--device cpu``):
    python -m genpose_tpu_torch.tools.convergence_check [--pair] [--device cpu]
    EVAL_EVERY=250 N_STEPS=9000 python -m genpose_tpu_torch.tools.convergence_check
    TRAIN_DTYPE=bfloat16 F32_STAGES=-2 EVAL_EVERY=250 N_STEPS=12000 \\
        python -m genpose_tpu_torch.tools.convergence_check
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
from genpose_tpu_torch.ops.pose import get_rot_matrix, quat_wxyz_to_matrix, rot_diff_degree
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils.benchmarking import card_line
from genpose_tpu_torch.utils.device import resolve_device

N_OBJ, N_POINTS = 4, 1024
ENERGY_NOISE = (0.01, 0.05, 0.15, 0.4, 1.0)  # candidate k's noise scale: lower k, better pose
ENERGY_CLASS = 2  # "camera": no symmetry, as the task's random clouds have none
ENERGY_ITERS = 200  # the energy check's iterations (the JAX test's 120 at its tiny width)


def knobs(env=None) -> Dict:
    """The JAX tool's environment knobs, with its defaults."""
    env = os.environ if env is None else env
    return {
        "batch_size": int(env.get("TRAIN_BATCH", "64")),
        "n_steps": int(env.get("N_STEPS", "3000")),
        "lr": float(env.get("LR", "1e-3")),
        "compute_dtype": env.get("TRAIN_DTYPE", "float32"),
        "head_dtype": env.get("HEAD_DTYPE", "compute"),
        "bn_dtype": env.get("BN_DTYPE", "compute"),
        "geometry_dtype": env.get("GEOM_DTYPE", "compute"),
        "encoder_f32_stages": int(env.get("F32_STAGES", "0")),
        "gather_grad": env.get("GATHER_GRAD", "exact"),
        "gather_fwd": env.get("GATHER_FWD", "exact"),
        "eval_every": int(env.get("EVAL_EVERY", "0")),
        "rot_crit": float(env.get("ROT_CRIT", "41.0")),
        "trans_crit": float(env.get("TRANS_CRIT", "3.9")),
    }


def _precision(k: Dict) -> Dict:
    return {n: k[n] for n in ("compute_dtype", "head_dtype", "bn_dtype", "geometry_dtype",
                              "encoder_f32_stages")}


def score_config(k: Dict, num_points: int = N_POINTS) -> Config:
    """The JAX tool's ``Config`` (its precision knobs from ``k``)."""
    return Config(num_points=num_points, repeat_num=20, batch_size=k["batch_size"], lr=k["lr"],
                  warmup=100, gather_grad=k["gather_grad"], gather_fwd=k["gather_fwd"],
                  **_precision(k))


def make_task(seed: int = 0, n_obj: int = N_OBJ, n_points: int = N_POINTS) -> np.ndarray:
    """The fixed library of clouds [n_obj, n_points, 3] (float32, ~0.1 m spread)."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_obj, n_points, 3)).astype(np.float32) * 0.1


def make_batch(clouds: torch.Tensor, bs: int, generator: torch.Generator, device):
    """One batch of the task at fresh poses, drawn on the CPU from the CPU
    ``clouds`` and ``generator`` (so the CPU and the card see the same
    batches) and moved to ``device``: (batch, gt [bs, 9] camera-frame 6-D
    pose + translation).  The batch has the keys of the score and energy
    training steps and of ``sample``."""
    which = torch.randint(0, clouds.shape[0], (bs,), generator=generator)
    g = torch.randn((bs, 3, 3), generator=generator)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    q[:, :, 0] = q[:, :, 0] * torch.sign(torch.linalg.det(q))[:, None]
    t = torch.rand((bs, 3), generator=generator) * 0.4 - 0.2
    pts = torch.einsum("bij,bnj->bni", q, clouds[which]) + t[:, None, :]
    center = pts.mean(dim=1)
    gt = torch.cat([q[:, :, 0], q[:, :, 1], t], dim=-1)  # first two COLUMNS of R
    zero_gt = torch.cat([gt[:, :6], gt[:, 6:] - center], dim=-1)
    batch = {
        "zero_mean_pts": pts - center[:, None, :],
        "zero_mean_gt_pose": zero_gt,
        "pts_center": center,
        "gt_pose": gt,
        "id": torch.full((bs,), ENERGY_CLASS, dtype=torch.int32),
        "handle_visibility": torch.ones((bs,), dtype=torch.int32),
    }
    return {k: v.to(device) for k, v in batch.items()}, gt.to(device)


def sampled_errors(agent: PoseAgent, clouds: torch.Tensor, bs: int, seed: int = 999,
                   sample_seed: int = 1000, num_steps: int = 100):
    """(mean rotation error in degrees, mean translation error in metres) of
    one Heun ``ode`` sample a cloud (EMA shadow) on the held-out batch drawn
    from ``seed``."""
    batch, gt = make_batch(clouds, bs, torch.Generator().manual_seed(seed), agent.device)
    gen = torch.Generator(device=agent.device).manual_seed(sample_seed)
    pred = agent.sample(batch, gen, repeat_num=1, sampler="ode", num_steps=num_steps)[:, 0]
    re = rot_diff_degree(get_rot_matrix(pred[:, :6], "rot_matrix").double(),
                         get_rot_matrix(gt[:, :6], "rot_matrix").double()).cpu().numpy()
    te = torch.linalg.norm(pred[:, -3:] - gt[:, -3:], dim=-1).cpu().numpy()
    return float(re.mean()), float(te.mean())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Dict[str, int]:
    return {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}


def _reset_launches() -> None:
    fps_cuda.launches = ball_query_cuda.launches = 0


def train_score(agent: PoseAgent, clouds: torch.Tensor, k: Dict,
                log: Callable[[str], None] = print, train_seed: int = 7) -> Dict:
    """Train ``agent`` on the task for ``k["n_steps"]`` steps, or in
    criterion mode (``k["eval_every"]`` > 0) until the first evaluation
    under ``k["rot_crit"]`` degrees and ``k["trans_crit"]`` cm.  Batches
    come from a CPU generator and the DSM draws from a device generator,
    both seeded ``train_seed``.  Returns the losses, the evaluations, the
    steps run, the training seconds (the first step and the evaluation
    pauses left out) and the FPS / ball-query launches per step and per
    evaluation."""
    dev = agent.device
    bs = k["batch_size"]
    batch_gen = torch.Generator().manual_seed(train_seed)
    loss_gen = torch.Generator(device=dev).manual_seed(train_seed)
    re0, te0 = sampled_errors(agent, clouds, bs)
    log(f"init: rot_err {re0:.1f} deg  trans_err {te0 * 100:.1f} cm")
    evals = [{"step": 0, "rot_deg": re0, "trans_m": te0}]
    losses = []
    eval_s, first_step_s, met_at = 0.0, None, None
    eval_launches = {"fps": 0, "ball_query": 0}
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(k["n_steps"]):
        batch, _ = make_batch(clouds, bs, batch_gen, dev)
        losses.append(agent.train_step(batch, loss_gen)["gf"])
        if i == 0:
            # the first step builds the kernels and warms the libraries up:
            # left out of the training seconds, as the JAX tool leaves out
            # its compilation
            _sync(dev)
            first_step_s = time.perf_counter() - t0
            log(f"first step (kernel builds and warm-up, excluded): {first_step_s:.2f} s")
            t0 = time.perf_counter()
        if i % 100 == 0:
            log(f"step {i}: dsm {float(losses[-1]):.3f}")
        if k["eval_every"] and (i + 1) % k["eval_every"] == 0:
            _sync(dev)
            t_eval, before = time.perf_counter(), _launches()
            re_i, te_i = sampled_errors(agent, clouds, bs)
            eval_s += time.perf_counter() - t_eval
            for n, v in _launches().items():
                eval_launches[n] += v - before[n]
            wall = time.perf_counter() - t0 - eval_s
            evals.append({"step": i + 1, "rot_deg": re_i, "trans_m": te_i, "train_s": wall})
            log(f"criterion check @{i + 1}: rot {re_i:.1f} deg trans {te_i * 100:.1f} cm  "
                f"train_wall {wall:.1f}s")
            if re_i < k["rot_crit"] and te_i * 100 < k["trans_crit"]:
                met_at = i + 1
                log(f"CRITERION MET at step {i + 1}: {wall:.1f}s training wall-clock "
                    f"(rot {re_i:.1f} < {k['rot_crit']}, trans {te_i * 100:.1f} < "
                    f"{k['trans_crit']} cm)")
                break
    _sync(dev)
    wall = time.perf_counter() - t0 - eval_s
    launches = {n: v - eval_launches[n] for n, v in _launches().items()}
    steps = len(losses)
    dsm = torch.stack(losses).float().cpu().numpy()
    timed = max(steps - 1, 1)  # the first step is left out of the wall time
    out = {"steps": steps, "train_s": wall, "samples_per_s": timed * bs / wall,
           "first_step_s": first_step_s, "eval_s": eval_s, "dsm_first": float(dsm[0]),
           "dsm_last": float(dsm[-1]), "dsm_first10": float(dsm[:10].mean()),
           "dsm_last10": float(dsm[-10:].mean()), "evals": evals, "met_at": met_at,
           "launches_per_step": {n: v / steps for n, v in launches.items()},
           "launches_per_eval": {n: v / max(len(evals) - 1, 1) for n, v in eval_launches.items()}}
    log(f"{steps} steps in {wall:.1f}s ({out['samples_per_s']:.0f} samples/s)")
    return out


def fixed_mode_check(agent: PoseAgent, clouds: torch.Tensor, k: Dict, run: Dict,
                     log: Callable[[str], None] = print) -> Dict:
    """The JAX tool's fixed-mode asserts on a finished ``train_score`` run."""
    re0, te0 = run["evals"][0]["rot_deg"], run["evals"][0]["trans_m"]
    re1, te1 = sampled_errors(agent, clouds, k["batch_size"])
    first, last = run["dsm_first"], run["dsm_last"]
    log(f"dsm {first:.2f} -> {last:.2f}; rot {re0:.1f} -> {re1:.1f} deg; "
        f"trans {te0 * 100:.1f} -> {te1 * 100:.1f} cm")
    if not last < first / 2:
        raise AssertionError(f"the DSM loss did not halve: {first} -> {last}")
    if not (re1 < re0 / 3 and te1 < te0 / 20):
        raise AssertionError(f"rotation {re0} -> {re1} deg (needs < /3), translation "
                             f"{te0} -> {te1} m (needs < /20)")
    log("CONVERGED OK")
    return {"rot_deg": re1, "trans_m": te1}


def energy_config(k: Dict, num_points: int = N_POINTS) -> Config:
    """The energy check's config: ``tests/test_convergence.py``'s energy
    recipe (2 DSM draws, lr 1e-3, warm-up 10) at full width."""
    return Config(num_points=num_points, repeat_num=2, batch_size=k["batch_size"], lr=1e-3,
                  warmup=10, **_precision(k))


def _candidates(gt: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """K=5 camera-frame candidates around ``gt`` [bs, 9], candidate k with
    noise scale ``ENERGY_NOISE[k]``."""
    scales = torch.tensor(ENERGY_NOISE)
    noise = torch.randn((gt.shape[0], len(ENERGY_NOISE), gt.shape[-1]), generator=generator)
    return gt[:, None, :] + (noise * scales[None, :, None]).to(gt.device)


def train_energy_ranking(cfg: Config, clouds: torch.Tensor, iters: int, device,
                         log: Callable[[str], None] = print, seed: int = 11) -> tuple:
    """Train an energy net with DSM + ranking on the task's candidates
    (``ENERGY_NOISE``), then hold it to the JAX test's bounds: the mean
    ranking loss of the last 10 iterations below 0.7 and more than 0.15 below
    the first 10's, and the best candidate's rotation energy (``get_energy``
    at T=1e-5) above the worst's in more than 80% of a held-out batch.
    Returns (agent, numbers)."""
    agent = PoseAgent(cfg, "energy", device=device, steps_per_epoch=1000)
    bs = cfg.batch_size
    batch_gen = torch.Generator().manual_seed(seed)
    loss_gen = torch.Generator(device=agent.device).manual_seed(seed)
    ranks, dsm = [], []
    _reset_launches()
    _sync(agent.device)
    t0 = time.perf_counter()
    for i in range(iters):
        batch, gt = make_batch(clouds, bs, batch_gen, agent.device)
        out = agent.train_step_energy(batch, _candidates(gt, batch_gen), loss_gen)
        ranks.append(out["ranking"])
        dsm.append(out["gf"])
        if i % 50 == 0:
            log(f"energy iteration {i}: ranking {float(ranks[-1]):.3f} dsm {float(dsm[-1]):.3f}")
    _sync(agent.device)
    wall = time.perf_counter() - t0
    launches = _launches()
    rank = torch.stack(ranks).float().cpu().numpy()
    first, last = float(rank[:10].mean()), float(rank[-10:].mean())
    batch, gt = make_batch(clouds, bs, torch.Generator().manual_seed(777), agent.device)
    cands = _candidates(gt, torch.Generator().manual_seed(778))
    e = agent.get_energy(batch, cands, T=1e-5).cpu().numpy()  # [bs, K, 2]
    frac = float(np.mean(e[:, 0, 0] > e[:, -1, 0]))
    out = {"iterations": iters, "ranking_first10": first, "ranking_last10": last,
           "dsm_first": float(dsm[0]), "dsm_last": float(dsm[-1]), "order_fraction": frac,
           "s_per_iteration": wall / iters,
           "launches_per_iteration": {n: v / iters for n, v in launches.items()}}
    log(f"energy + ranking: ranking {first:.3f} -> {last:.3f}; best above worst in "
        f"{frac:.3f} of {bs}; {wall / iters:.4f} s per iteration")
    if not (last < 0.7 and last < first - 0.15):
        raise AssertionError(f"ranking loss {first} -> {last} (needs < 0.7 and a fall > 0.15)")
    if not frac > 0.8:
        raise AssertionError(f"the best candidate's energy is above the worst's in {frac} "
                             f"(needs > 0.8)")
    return agent, out


def _served_errors(out: Dict, gt: torch.Tensor, key: str) -> Dict:
    """Mean rotation (degrees) and translation (cm) errors of the served
    ``out[key]`` (wxyz quaternion + camera-frame translation) against gt."""
    pose = torch.from_numpy(out[key])
    rot = quat_wxyz_to_matrix(pose[:, :4])
    g = gt.cpu()
    re = rot_diff_degree(rot.double(), get_rot_matrix(g[:, :6], "rot_matrix").double()).numpy()
    te = torch.linalg.norm(pose[:, 4:] - g[:, 6:], dim=-1).numpy() * 100
    return {"rot_deg": float(re.mean()), "trans_cm": float(te.mean())}


def serving_config(k: Dict, num_points: int = N_POINTS, **overrides) -> Config:
    """The served pipeline: K=50 hypotheses, Heun ``ode`` at the evaluation's
    100 steps from T0 1.0, top-60% pooling, at the training batch."""
    kw = dict(num_points=num_points, batch_size=k["batch_size"], eval_repeat_num=50,
              sampler_mode=("ode",), sampling_steps=100, T0=1.0, ratio=0.6, **_precision(k))
    kw.update(overrides)
    return Config(**kw)


def serve_trained(cfg: Config, score_ckpt: str, energy_ckpt: str, clouds: torch.Tensor,
                  device, log: Callable[[str], None] = print, seed: int = 4242) -> Dict:
    """Serve the saved pair frozen through ``InferencePipeline(score_ckpt=,
    energy_ckpt=)`` on ``cfg.batch_size`` held-out clouds at fresh poses
    (camera frame), and the same pipeline with the untrained weights (the
    agents' seeded initialisation); errors of the pooled ``pred_pose`` and
    of the best-energy ``best_pose``, the seconds of a frozen request after
    its warm-up, and the FPS / ball-query launches of that request."""
    from genpose_tpu_torch.runners.serving import InferencePipeline

    dev = resolve_device(device)
    batch, gt = make_batch(clouds, cfg.batch_size, torch.Generator().manual_seed(seed), dev)
    # predict takes camera-frame clouds and returns camera-frame poses (it
    # subtracts the cloud's centre and the samplers add it back)
    pts = (batch["zero_mean_pts"] + batch["pts_center"][:, None, :]).cpu().numpy()
    res = {}
    for arm, ckpts in (("untrained", {}),
                       ("trained", {"score_ckpt": score_ckpt, "energy_ckpt": energy_ckpt})):
        pipe = InferencePipeline(cfg, device=dev, **ckpts).freeze()
        pipe.predict(pts, torch.Generator(device=dev).manual_seed(1))  # captures the graphs
        _sync(dev)
        _reset_launches()
        t0 = time.perf_counter()
        out = pipe.predict(pts, torch.Generator(device=dev).manual_seed(2))
        _sync(dev)
        secs = time.perf_counter() - t0
        res[arm] = {"pooled": _served_errors(out, gt, "pred_pose"),
                    "best": _served_errors(out, gt, "best_pose"),
                    "request_s": secs, "launches": _launches()}
        del pipe
    t, u = res["trained"], res["untrained"]
    log(f"served frozen (bs={cfg.batch_size}, K={cfg.eval_repeat_num}, Heun-"
        f"{cfg.sampling_steps}, top {cfg.ratio:.0%} pooled): pooled rot "
        f"{t['pooled']['rot_deg']:.2f} deg trans {t['pooled']['trans_cm']:.2f} cm, best-energy "
        f"rot {t['best']['rot_deg']:.2f} deg trans {t['best']['trans_cm']:.2f} cm; untrained "
        f"pooled rot {u['pooled']['rot_deg']:.2f} deg trans {u['pooled']['trans_cm']:.2f} cm; "
        f"request {t['request_s']:.4f} s; launches {t['launches']}")
    return res


def check_served(served: Dict, k: Dict, criterion: bool) -> None:
    """The pooled served errors meet the criterion (criterion mode) or the
    fixed mode's ratios against the untrained pipeline."""
    t, u = served["trained"]["pooled"], served["untrained"]["pooled"]
    if criterion:
        ok = t["rot_deg"] < k["rot_crit"] and t["trans_cm"] < k["trans_crit"]
    else:
        ok = t["rot_deg"] < u["rot_deg"] / 3 and t["trans_cm"] < u["trans_cm"] / 20
    if not ok:
        raise AssertionError(f"served pooled errors {t} (untrained {u}) miss the "
                             f"{'criterion' if criterion else 'fixed-mode ratios'}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--pair", action="store_true",
                   help="then train the energy net and serve the trained pair frozen")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    k = knobs()
    cfg = score_config(k, N_POINTS)
    print(f"config: bs={k['batch_size']} lr={k['lr']:g} compute={cfg.compute_dtype} "
          f"head={cfg.head_dtype} bn={cfg.bn_dtype} geom={cfg.geometry_dtype} "
          f"f32_stages={cfg.encoder_f32_stages} device={dev}", flush=True)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    log = lambda s: print(s, flush=True)  # noqa: E731
    clouds = torch.from_numpy(make_task(n_points=N_POINTS))
    agent = PoseAgent(cfg, "score", device=dev, steps_per_epoch=100)
    run = train_score(agent, clouds, k, log)
    criterion = bool(k["eval_every"])
    if criterion:
        if run["met_at"] is None:
            log(f"CRITERION NOT MET within {k['n_steps']} steps ({run['train_s']:.1f}s)")
        if not args.pair or run["met_at"] is None:
            return 0
    else:
        fixed_mode_check(agent, clouds, k, run, log)
        if not args.pair:
            return 0
    from genpose_tpu_torch.training.checkpoints import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        score_ckpt = save_checkpoint(os.path.join(tmp, "score"), agent, 0)
        energy, _ = train_energy_ranking(energy_config(k, N_POINTS), clouds, ENERGY_ITERS,
                                         dev, log)
        energy_ckpt = save_checkpoint(os.path.join(tmp, "energy"), energy, 0)
        del agent, energy
        served = serve_trained(serving_config(k, N_POINTS), score_ckpt, energy_ckpt, clouds,
                               dev, log)
    check_served(served, k, criterion)
    log("SERVED OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
