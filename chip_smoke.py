"""Smoke test of genpose_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout on a machine with a card:

    python3 chip_smoke.py

It needs the CUDA toolkit (``nvcc``) and PyTorch built for CUDA; it never
imports JAX.  Phases, each of which raises on failure (a failure exits
non-zero and prints no result line):

1. the card's name and power limit, from ``nvidia-smi``;
2. build the CUDA kernels from ``genpose_tpu_torch/csrc`` (``ops/_build.py``);
3. hold each kernel against its plain PyTorch version, bit for bit, at the
   shapes the paths give them (B=64 clouds of 1024 points, the serving
   batch, and B=192, the training batch: FPS 1024->512, 512->256, 256->128
   and one ball-query launch for both radii of each stage; the fused FPS +
   ball query at the three stages at B=64 and B=192, also against the
   separate kernels), plus ties, an unaligned N, npoint > N, empty balls,
   exact-boundary cases, a three-radius ball query with r=0, eight radii
   and the JAX fused-kernel test's cases; time each kernel and its plain
   version at B=64 with CUDA events and by ``torch.profiler`` (device ms,
   and for FPS and the fused kernel us per FPS round);
4. the fused kernel's path: the three-stage geometry chain of
   ``tools/bench_fused_geometry.py``, once per arm with the launch counts
   read around it, then both arms timed (the fused kernel's win or loss)
   and each arm's kernels' device time in one chain profiled;
5. drive the serving path at the released model's full width
   (``InferencePipeline``: bs=64, K=50, N=1024, light PointNet++, VE SDE,
   Rx_Ry_and_T heads) with seeded random non-zero weights, once with the
   Heun ``ode`` sampler and once with ``ode_adaptive``; check that each run
   launched FPS 3 times and ball query 3 times per chunk, and that the
   outputs are finite and well formed;
   then split one more request by stage and profile it (device busy share,
   top kernels);
6. run one small batch through the same pipeline on the card and on the
   CPU, with the same weights and prior noise, and compare;
7. drive the training path at the released recipe's full width (bs=192,
   N=1024, 20 DSM draws, Adam lr 1e-3 with warmup 100, clip 1.0, EMA 0.999,
   the default augmentation) on synthetic batches from a seed:
   ``train_score`` for SCORE_STEPS steps and its eval epoch, then
   ``train_energy(ranking=True)`` for ENERGY_STEPS iterations with the
   trained score agent as teacher (K=5 candidates by ``ode_adaptive``).
   Checks: finite losses, params unchanged by the first step (lr 0) and
   changed by the second, BatchNorm statistics moved, EMA shadow apart from
   the live params, FPS 3 and ball query 3 launches per score step and per
   energy iteration (one geometry pass shared by the candidates and the
   energy step).  Prints seconds per step, samples/s, peak memory, a stage
   split of one score step and the device busy share;
8. 3 score and 2 energy steps at a small size on the card and on the CPU,
   same weights, batches and draws: loss trajectories, final state and each
   parameter's update compared; a control run with zeroed gradients must
   fail the update check;
9. drive ``runners/evaluation_single.py``'s four stages at the released
   model's full width (K=50, N=1024, T0=0.55, batch 192, Heun-500) on a
   synthetic Real/test tree of EVAL_SCENES scenes at 640x480 written by
   the port's ``make_synthetic_nocs_dir`` (the scene count is the only
   cut): seconds per stage, stage-2 poses/s, FPS 3 and ball query 3
   launches in every stage-2 and stage-3 chunk, the headline mAP (about 0
   with random weights); FPS and ball query held against their plain
   versions on the largest category chunk; then stage 4 alone on a copy of
   ``results_with_energy.pkl`` whose hypotheses lie within 1 degree and
   0.5 cm of GT must reach a mean 10deg5cm mAP >= 99 over the classes
   present;
10. drive ``runners/evaluation_tracking.py::main_tracking`` (T0=0.15) on the
   same tree: frames/s, FPS 3 and ball query 3 launches per frame, the
   device busy share of one profiled frame, the tracking metrics.  Phases 9
   and 10 run the agents unfrozen (``main_tracking``'s ``freeze`` is made a
   no-op for the run): they are the eager arms of phase 12;
11. stages 2-4 and 3 tracking frames on a small tree on the card and on the
   CPU (N=128, K=4, 8 Heun steps, same weights, prior rows and pose noise):
   RTs, energies and pooled poses within CPU_GPU_TOL scaled by magnitude,
   identical mAP tables;
12. frozen against eager (``freeze()``, CUDA graphs): a full-width served
   request under each sampler, eagerly and then frozen from the same
   generator state; stages 2-3 of phase 9's tree with both agents frozen
   (as ``evaluation_single.main`` runs them); ``main_tracking`` as a user
   calls it on phase 10's frames.  Each frozen result must equal its eager
   arm bit for bit or within FROZEN_TOL scaled (the line says which), the
   mAP tables and tracking metrics must be identical, FPS 3 and ball query
   3 must launch per request, chunk and frame, and the frozen-dispatch
   counter must count 2 per request, chunk pair and frame.  After
   ``perturb_`` of the score weights the score agent must run eagerly, and
   a new ``freeze()`` must equal eager under the new weights.  Prints each
   arm's seconds, poses/s or frames/s, busy share and device kernels, the
   warm-up and capture seconds of each program and the device memory the
   frozen serving programs hold;
13. bfloat16 (``compute_dtype="bfloat16"``, the JAX package's serving
   precision): stages 2-3 of phase 9's tree and ``main_tracking`` on phase
   10's frames with bfloat16 agents frozen (seconds, poses/s, frames/s,
   FPS 3 + ball query 3 per chunk and frame); then serving at full width
   under each sampler, a bfloat16 pipeline eagerly and frozen (bit for bit)
   beside the float32 one, bfloat16 against float32 per hypothesis on the
   same prior rows within BF16_BUDGET (``tests/test_bf16.py``'s), each
   arm's seconds, poses/s, busy share, device ms and kernels and the memory
   the frozen bfloat16 programs hold; a small bfloat16 batch on the card
   against the CPU within CPU_GPU_BF16_TOL; and ``train_score`` at the
   released recipe under ``--compute_dtype bfloat16 --encoder_f32_stages
   -2`` (seconds per step, samples/s, peak memory, finite losses, FPS 3 +
   ball query 3 per step, float32 state);
14. checkpoint interchange and the other SDEs and samplers: the serving
   phase's seeded weights written as released GenPose ``.pth`` files in the
   reference's torch layout (``upstream_state_dict``), converted by
   ``genpose_tpu_torch/tools/port_torch_ckpt.py`` and loaded with
   ``InferencePipeline(score_ckpt=, energy_ckpt=)``: its predictions must
   equal the directly loaded pipeline's bit for bit; one full-width request
   each under PC (VE, 500 steps), VP Heun-500 and EDM (18 steps): seconds,
   poses/s, busy share, FPS 3 + ball query 3 launches; the card against the
   CPU on a small batch with the same injected draws (PC, VP, EDM samples
   and the energies of the CPU's samples within CPU_GPU_TOL scaled) and the
   PF-ODE likelihood of two poses on both (FPS 3 + ball query 3 on the
   card);
15. the training CLI, ``runners/trainer.py::main`` as a user calls it, on a
   synthetic NOCS-format tree written by the port's ``make_synthetic_nocs_dir``
   at 640x480 (CLI_CAMERA_SCENES CAMERA and CLI_REAL_SCENES Real train
   scenes, two full batches of 192 an epoch after the CAMERA:Real
   resampling; the scene count is the only cut) at the released recipe's
   width (bs=192, N=1024, repeat 20, Adam lr 1e-3 with warm-up, clip 1.0,
   EMA 0.999, the default DZI, 2-D deformation and point augmentation,
   Heun-500 in the eval epoch): first one train epoch of each loader mode
   (8 workers; the process pool forks after CUDA init) with samples/s and
   bit-identical batches, one sample's host time split by function (the
   three PNG decodes, the crops, ``defor_2D``, back-projection; and one
   colour image decoded from Paeth-filtered rows), FPS and ball query
   against their plain versions on a loader batch's clouds (tiled
   duplicate points: exact ties); then ``--agent_type score --loader_mode
   process`` for 2 epochs with ``--eval_freq 1``, two resumes of one epoch each (``--use_pretrain
   true --n_epochs 3``, then 4: the clock advances one epoch each time),
   the first with the default thread loader and the second with the
   process loader, each profiled: seconds per step fed from the loader
   beside phase 7's in-memory step, the share of the epoch spent waiting
   for batches, the device busy share; ``energy_with_ranking`` from the
   score checkpoint (K=5 candidates by ``ode_adaptive``, one epoch, the
   process loader); and
   on Real/test ``--eval`` (repeat CLI_EVAL_REPEAT), ``--results_path``,
   ``--pred`` and ``--likelihood`` (CLI_LIKELIHOOD_STEPS steps) with
   ``--max_eval_num 0``; last, one more score epoch with ``--save_video
   true`` (its eval epoch samples with the trajectory, CLI_VIDEO_STEPS Heun
   steps, and writes ``res_grid.png`` and each sample's diffusion frames as
   PNGs: the frames counted, the drawing's host seconds printed).  Checks:
   finite logged losses, every artifact of each flow (``--pred``'s SO(3)
   images or the line saying why they were skipped: the card's machine has
   no matplotlib), FPS 3 + ball query 3 in every score step, energy
   iteration, eval-epoch and inference sampling, energy and likelihood
   call, and no launch outside them;
16. every other encoder, PointNet++ stage config and pose mode of the JAX
   config (NEW_CONFIGS: ``pts_encoder`` ``pointnet`` and
   ``pointnet_and_pointnet2``, ``pointnet2_params`` ``full``, ``lighter``
   and ``dense``, ``pose_mode`` ``euler_xyz_sx_cx`` with ``R_and_T``):
   FPS and ball query against their plain versions, bit for bit, at every
   stage of the full, lighter and dense chains (``Pointnet2MSG``'s is
   full's first four stages), on object clouds and on clouds tiled from
   200 points (exact duplicates), each shape that phase 3 does not run
   timed with its bound; ``Pointnet2MSG`` once on the card (4 + 4
   launches) against the CPU; per configuration a full-width Heun-500
   request eagerly and then frozen (bit for bit, 2 frozen dispatches, the
   frozen request profiled; FPS and ball query 0, 3 or 4 times a request
   as the encoder has stages) and the phase-5 check against the CPU; and
   NEW_TRAIN_STEPS score steps at bs=192 for ``pointnet_and_pointnet2``
   and ``full`` (seconds per step beside phase 7's, peak memory, launches).
17. every sampler through the frozen programs (``freeze()``) at the
   serving width: a PC-500 (VE) and an EDM-18 request in float32 and
   bfloat16, eagerly and then frozen from the same seed (each after a
   warm-up request): bit for bit, 2 frozen dispatches and FPS 3 + ball
   query 3 a request; seconds and poses/s beside phase 14's eager seconds,
   the frozen request's busy share, device ms and kernels, the warm-up and
   capture seconds and the graph pool's device memory; a Heun-500 and a
   PC-500 request with the trajectory (``return_process``) and the PF-ODE
   likelihood (LIKELIHOOD_STEPS steps) of 64 poses, eagerly and frozen, bit
   for bit; ``evaluation_single`` stages 2-3 on phase 9's tree under
   ``--sampler_mode pc`` with both agents frozen as ``main`` freezes them,
   and ``main_tracking`` on phase 10's frames under ``--sde_mode edm
   --sampler_mode edm``, each against its eager port run (bit for bit,
   equal metrics), with stage-2 poses/s and frames/s;
18. data parallelism through ``genpose_tpu_torch/parallel`` (spawned
   workers, ``parallel.launch``): (a) a group of one over NCCL, where
   every helper is the identity and the single process's program runs,
   (b) two ranks sharing the card over gloo (asked for by name), which run
   the global BatchNorm, gradient mean and norms, (c) two cards over NCCL
   where the machine has them; each rank takes DP_SCORE_STEPS score
   steps and DP_ENERGY_ITERS energy-with-ranking iteration at the released
   recipe's width (global bs=192, N=1024, repeat 20) and one request of
   the serving pipeline under the group (bs=64, K=50, Heun-500, then RK45);
   every arm within DP_TOL of the single-process run of the same work on the
   same batches, draws and weights, every rank's parameters equal, FPS 3 +
   ball query 3 launches per step, iteration and request in every rank;
   seconds per step, the all-reduce's share of a step and peak memory per
   rank.  Two ranks on one card show that the program is right, not how it
   scales;
19. ``utils/benchmarking.py::time_chain_marginal`` (CUDA events) over the
   three-stage geometry chain (the kernels) and over the frozen float32
   Heun-500 request, beside phase 12's host-clock seconds for that request;
20. the host C helper (``genpose_tpu_torch/native``, ``g++``; built from its
   source after the CUDA kernels, before any phase calls it): the train
   loader's first batch (HELPER_BATCH samples) on phase 15's tree fetched
   through it and through
   the plain Python stream (``GENPOSE_NO_NATIVE=1``), bit for bit, with one
   helper call per sample on the first and none on the second; its five
   entry points (``depth_mask_to_pcl``, ``sample_points``,
   ``backproject_sample``, ``fps`` on each cloud and batched) against their
   plain versions on that batch's ROIs and clouds (tiled duplicate points:
   exact ties); ms per call of the helper and the Python stream on
   120x120, 240x240 and 440x440 ROIs; one sample's host split under the
   plain stream beside phase 15's split and loader rates, which go through
   the helper;
21. the convergence check (``genpose_tpu_torch/tools/convergence_check.py``,
   ``convergence``): the released score net at full width (bs=64, N=1024,
   repeat 20, Adam lr 1e-3, warm-up 100, float32) trained on the synthetic
   4-object task until Heun-100 samples from its EMA shadow meet the
   criterion (rotation under 41 deg and translation under 3.9 cm, checked
   every CONV_EVAL_EVERY steps; failing by CONV_MAX_STEPS fails the phase);
   an energy net trained with the ranking loss under the JAX test's bounds
   (ranking loss under 0.7 and down by 0.15, best candidate's energy above
   the worst's in more than 80% of a held-out batch); both saved and served
   frozen through ``InferencePipeline(score_ckpt=, energy_ckpt=)`` (K=50,
   Heun-100, top 60% pooled) on 64 held-out clouds, whose pooled poses must
   meet the criterion; steps and training seconds to the criterion,
   samples/s, the losses and errors before and after, the served errors
   (pooled, best-energy, untrained) and the request's seconds; FPS 3 +
   ball query 3 per score step, evaluation, energy iteration and request.
   It runs after phase 8, with the other training phases.
22. the fused score head (``csrc/score_head.cu`` through
   ``ops/score_head_cuda.py``), run after phase 4: ``-Xptxas -v``'s
   registers and spills of its two kernels; at the evaluation shape (256
   clouds x K=50 = 12,800 rows, t = 0.55) against the plain arithmetic
   (largest gap over the largest output, SCORE_HEAD_TOL), two calls bit for
   bit; ms per evaluation by CUDA events over SCORE_HEAD_CALLS back-to-back
   calls of the kernel pair, of ``score_from`` (sigma(t) included) and of
   the plain arithmetic, the kernels' device ms by ``torch.profiler``, all
   beside the float32 bound; then one frozen Heun-500 bs=256 request of the
   benchmark's ``genpose_light.eval_b256`` cell (its harness, weights and
   clouds from SCORE_HEAD_SEED) and its ``pose_gap`` against
   ``portbench/reference``, under the cell's limit.
23. the eval-mode grouped SA stage kernel (``csrc/sa_stage.cu`` through
   ``ops/sa_stage_cuda.py``), run after phase 22: ``-Xptxas -v``'s
   registers and spills of each instantiation (none may spill); each light
   stage 0-2 radius at 256 clouds against the plain chain (largest gap
   over the largest output, SA_STAGE_TOL), two calls bit for bit; each
   radius's device ms by ``torch.profiler`` and ms by CUDA events over
   SA_STAGE_CALLS calls beside its float32 bound and the plain chain's ms;
   one encoder pass (stages 0-3) fused and plain; then one request of the
   ``genpose_light.eval_b256`` cell (weights and clouds from SA_STAGE_SEED)
   and its ``pose_gap`` / ``energy_gap`` under the cell's limits.

Checkpoints and metrics of phase 7, the trees and results of phases 9-12,
the converted checkpoints of phase 14, the tree and results of phase 15 and
the trained pair of phase 21 go under ``build/chip_smoke/`` in the
checkout.  The last lines are the training numbers, the evaluation and
tracking numbers, the frozen arms, the bfloat16 arms, the checkpoint and
sampler numbers, the training CLI's numbers, phase 16's, 17's, 18's, 19's,
20's, 21's, 22's and 23's numbers, the card line, one JSON line describing each
kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

FPS_SHAPES = [(1024, 512), (512, 256), (256, 128)]  # (N, npoint) of SA stages 0-2
BQ_RADII = [(0.02, 0.04), (0.04, 0.08), (0.08, 0.16)]
BQ_NSAMPLE = (16, 32)
B, K, N_POINTS = 64, 50, 1024
HEUN_STEPS = 500  # the config default; the whole run stays far inside its time limit
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CPU_GPU_TOL = 1e-3
B_TRAIN = 192  # the training batch of the released recipe
SCORE_STEPS, ENERGY_STEPS = 4, 3  # training steps at full width
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-4, 1e-4  # training CUDA vs CPU (phase 8)
TRAIN_UPDATE_RTOL = 0.2  # phase 8: a parameter's update, relative to its norm
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"  # checkpoints, logs
EVAL_SCENES = 24  # Real/test scenes of the synthetic tree (phases 9-10): the only cut
EVAL_T0, TRACK_T0 = 0.55, 0.15  # scripts/eval_single.sh, scripts/eval_tracking.sh
SCORE_HEAD_CALLS = 200  # phase 22: back-to-back score evaluations a timing
SCORE_HEAD_TOL = 1e-5  # phase 22: kernel against plain, over the largest |output|
SCORE_HEAD_SEED = 3000000037  # phase 22: the eval cell's weights and request
SA_STAGE_CALLS = 20  # phase 23: back-to-back calls of each radius a timing
SA_STAGE_TOL = 1e-5  # phase 23: kernel against plain, over the largest |output|
SA_STAGE_SEED = 3000000041  # phase 23: the eval cell's weights and request


@contextlib.contextmanager
def timing_calls(stages, *targets):
    """Within the block, each call of ``owner.name`` for (owner, name, stage)
    in ``targets`` is timed on the host clock, with the device synchronised
    on both sides, and its milliseconds are added to ``stages[stage]``."""
    saved = [(owner, name, vars(owner).get(name)) for owner, name, _ in targets]
    for owner, name, stage in targets:
        def wrapper(*args, _fn=getattr(owner, name), _stage=stage, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[_stage] = stages.get(_stage, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, name, wrapper)  # on an instance, this shadows the method
    try:
        yield stages
    finally:
        for owner, name, old in saved:
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: the larger of bytes over the memory
    rate and float32 operations over the peak float32 rate."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(shape: str, ms: float, plain_ms: float, n_bytes: float, n_ops: float, **extra):
    bnd, by = bound_ms(n_bytes, n_ops)
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bytes=n_bytes, ops=n_ops,
                bound_ms=bnd, bound_by=by, **extra)


# the fusion tails of each regression head in the released (upstream) layout:
# the flax tail name, the upstream module is "fusion_" + that name
UPSTREAM_TAILS = {"RT": ("tail",), "R_and_T": ("tail_rot", "tail_trans"),
                  "Rx_Ry_and_T": ("tail_rot_x", "tail_rot_y", "tail_trans")}


def upstream_state_dict(params, batch_stats, regression_head: str = "Rx_Ry_and_T",
                        decoder_head: bool = False):
    """A released GenPose ``GFObjectPose`` state_dict (the reference's
    torch layout, ``networks/posenet.py``) holding the given weights, which
    come in the flax layout (nested dicts of arrays: the JAX package's
    params and batch_stats, or ``utils/weights.py::to_jax_variables`` of a
    port model).  The inverse of ``utils/torch_port.py::port_gf_state_dict``:
    1x1-conv weights [out, in, 1, 1] (PointNet++) or [out, in, 1] (PointNet,
    the per-point heads) and Linear weights [out, in], each fusion tail one
    Linear over [pts_feat, t-or-sigma feat, pose_feat], BatchNorm as
    ``weight/bias/running_mean/running_var/num_batches_tracked``.  The
    encoder is read from the tree's names: ``encoder`` (PointNet++ or
    PointNet), or ``encoder_pn`` + ``encoder_pn2`` + ``fusion_layer``; a
    tail holding ``bias1`` is a per-point head."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd = {}

    def linear(key, dense, conv_dims=0):
        sd[f"{key}.weight"] = t(np.asarray(dense["kernel"]).T)[(...,) + (None,) * conv_dims]
        if "bias" in dense:
            sd[f"{key}.bias"] = t(dense["bias"])

    def batch_norm(key, scale_bias, stats):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = t(scale_bias["scale"]), t(scale_bias["bias"])
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = t(stats["mean"]), t(stats["var"])
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def pointnet2(prefix, enc, enc_stats):
        for sa, sa_p in enc.items():
            for mlp, mlp_p in sa_p.items():
                base = f"{prefix}SA_modules.{sa[3:]}.mlps.{mlp[4:]}"
                for name, leaf in mlp_p.items():
                    j = name.split("_")[1]
                    if name.startswith("dense"):
                        linear(f"{base}.layer{j}.conv", leaf, conv_dims=2)
                    else:
                        batch_norm(f"{base}.layer{j}.bn.bn", leaf, enc_stats[sa][mlp][name])

    def pointnet(prefix, enc):
        for i, src in enumerate(("conv1", "conv2", "conv3", "fc1", "fc2", "fc3")):
            linear(f"{prefix}stn.{src}", enc["stn"][f"Dense_{i}"], conv_dims=int(i < 3))
        for i in range(4):
            linear(f"{prefix}conv{i + 1}", enc[f"Dense_{i}"], conv_dims=1)

    if "encoder_pn" in params:
        pointnet("pts_pointnet_encoder.", params["encoder_pn"])
        pointnet2("pts_pointnet2_encoder.", params["encoder_pn2"], batch_stats["encoder_pn2"])
        linear("fusion_layer", params["fusion_layer"])
    elif "stn" in params["encoder"]:
        pointnet("pts_encoder.", params["encoder"])
    else:
        pointnet2("pts_encoder.", params["encoder"], batch_stats["encoder"])
    head = params["head"] if decoder_head else params["head"]["trunk"]
    pre = "pose_score_net."
    if decoder_head:
        linear(f"{pre}sigma_encoder.1", head["sigma_dense"])
    else:
        sd[f"{pre}t_encoder.0.W"] = t(head["t_fourier"]["W"])
        linear(f"{pre}t_encoder.1", head["t_dense"])
    linear(f"{pre}pose_encoder.0", head["pose_dense_0"])
    linear(f"{pre}pose_encoder.2", head["pose_dense_1"])
    for k, name in enumerate(UPSTREAM_TAILS[regression_head]):
        tail = f"{pre}fusion_{name}"
        if "tails" in head:  # the fused bank: tail k is the k-th block of columns
            bank = {n: np.asarray(v) for n, v in head["tails"].items()}
            h = bank["out_kernel"].shape[1]
            cols = slice(k * h, (k + 1) * h)
            w1 = np.concatenate([bank["feat_kernel"][:, cols], bank["t_kernel"][:, cols],
                                 bank["pose_kernel"][:, cols]], axis=0)
            linear(f"{tail}.0", {"kernel": w1, "bias": bank["bias"][cols]})
            linear(f"{tail}.2", {"kernel": bank["out_kernel"][k], "bias": bank["out_bias"][k]})
        elif "bias1" in head[name]:  # a per-point RotHead / TransHead
            pp, pp_stats = head[name], batch_stats["head"]["trunk"][name]
            w1 = np.concatenate([np.asarray(pp[n]) for n in ("feat_kernel", "t_kernel",
                                                              "pose_kernel")], axis=0)
            linear(f"{tail}.conv1", {"kernel": w1, "bias": pp["bias1"]}, conv_dims=1)
            for j in (1, 2, 3):
                batch_norm(f"{tail}.bn{j}", pp[f"bn{j}"], pp_stats[f"bn{j}"])
            for j in (2, 3, 4):
                linear(f"{tail}.conv{j}", pp[f"conv{j}"], conv_dims=1)
        else:
            split = head[name]
            w1 = np.concatenate([np.asarray(split["feat"]["kernel"]),
                                 np.asarray(split["dyn"]["kernel"])], axis=0)
            linear(f"{tail}.0", {"kernel": w1, "bias": split["dyn"]["bias"]})
            linear(f"{tail}.2", split["out"])
    return sd


def object_clouds(gen: torch.Generator, n: int, n_points: int, device, grid: float = 0.0):
    """n clouds of points on random ellipsoid surfaces, 3-15 cm semi-axes,
    with 2 mm noise: object-sized, as the NOCS categories are.  With
    ``grid``, coordinates are rounded to multiples of it (see phase 5)."""
    axes = torch.rand(n, 1, 3, generator=gen, device=device) * 0.12 + 0.03
    d = torch.randn(n, n_points, 3, generator=gen, device=device)
    pts = d / d.norm(dim=-1, keepdim=True) * axes
    pts = pts + torch.randn(n, n_points, 3, generator=gen, device=device) * 0.002
    if grid:
        pts = torch.round(pts / grid) * grid
    return pts.contiguous()


def examined_pairs(xyz, centers, radii, nsamples, tables):
    """What a multi-radius ball query whose rows stop at their nsample-th hit
    needs on this data: the (center, point) pairs up to the later of a
    center's row stops, the pairs up to each radius's own stop, and the mean
    hit count per center of each radius."""
    from genpose_tpu_torch.ops import pointcloud as pc

    d2 = pc._sq_dist(centers[:, :, None, :], xyz[:, None, :, :])
    stops, hits = [], []
    for radius, nsample, table in zip(radii, nsamples, tables):
        cnt = (d2 < pc.radius_sq_f32(radius)).sum(-1)
        full = torch.full_like(cnt, xyz.shape[1])
        stops.append(torch.zeros_like(cnt) if nsample == 0 else
                     torch.where(cnt >= nsample, table[..., -1].long() + 1, full))
        hits.append(float(cnt.float().mean()))
    later = torch.stack(stops).amax(0)
    return float(later.sum()), [float(st.sum()) for st in stops], hits


def device_ms(fn, iters: int, tags, per_call: int = 1):
    """Device milliseconds per call of the kernels whose name holds one of
    ``tags`` (a name or a tuple of them), by ``torch.profiler`` over ``iters``
    calls after a warm call: unlike CUDA events around back-to-back calls,
    it leaves out the host's issue time.  A call launches each tag's kernel
    ``per_call`` times; a trace that holds another count of any of them lost
    launches and is taken again.  After three such traces the time is not
    measured (None), which is printed."""
    tags = (tags,) if isinstance(tags, str) else tuple(tags)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = {t: [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                      and t in e.key] for t in tags}
        seen = {t: sum(e.count for e in ev) for t, ev in events.items()}
        if all(n == iters * per_call for n in seen.values()):
            return sum(e.self_device_time_total for ev in events.values() for e in ev) / 1e3 / iters
        print(f"profiler: the trace holds {seen} launches, {iters * per_call} of each expected "
              f"({[e.key[:60] for ev in events.values() for e in ev]})", flush=True)
    print(f"profiler: device time of {' + '.join(tags)} not measured", flush=True)
    return None


def _ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def per_round(dev_ms, npoint: int):
    """Microseconds per FPS round (npoint - 1 rounds a cloud), or None."""
    return None if dev_ms is None else dev_ms * 1e3 / (npoint - 1)


def _flat(x):
    """A kernel's result as one index vector: a tensor, or nested tuples of them."""
    if isinstance(x, torch.Tensor):
        return x.flatten()
    return torch.cat([_flat(t) for t in x])


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the serving shapes,
    and the fused kernel against its plain version and the separate kernels."""
    from genpose_tpu_torch.ops import pointcloud as pc
    from genpose_tpu_torch.ops.ball_query_cuda import ball_query_cuda
    from genpose_tpu_torch.ops.fps_bq_fused_cuda import fps_bq_fused_cuda
    from genpose_tpu_torch.ops.fps_cuda import fps_cuda
    from genpose_tpu_torch.tools.bench_fused_geometry import cuda_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    xyz = object_clouds(gen, B, N_POINTS, dev)
    xyz = xyz - xyz.mean(dim=1, keepdim=True)  # the pipeline zero-centers
    fps_rows, bq_rows, fused_rows = [], [], []
    err = 0  # max |kernel - plain| over every compared index

    def same(got, want, what):
        nonlocal err
        torch.cuda.synchronize()
        got, want = _flat(got), _flat(want)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain: {what}")
        err = max(err, int((got - want).abs().max()) if got.numel() else 0)

    for (n, npoint), radii in zip(FPS_SHAPES, BQ_RADII):
        got = fps_cuda(xyz, npoint)
        same(got, pc.farthest_point_sample_ref(xyz, npoint), f"FPS N={n} npoint={npoint}")
        ms = cuda_ms(lambda: fps_cuda(xyz, npoint), 50)
        dev_ms = device_ms(lambda: fps_cuda(xyz, npoint), 20, "fps_kernel")
        plain = cuda_ms(lambda: pc.farthest_point_sample_ref(xyz, npoint), 3)
        # per point per round: 3 sub, 3 mul, 2 add, 1 min, 1 compare
        fps_rows.append(row(f"B{B} N{n} npoint{npoint}", ms, plain,
                            B * n * 12 + B * npoint * 4, B * (npoint - 1) * n * 10,
                            device_ms=dev_ms, us_per_round=per_round(dev_ms, npoint)))
        centers = pc.gather_points(xyz, got)
        # ball query: both radii of the stage in one launch
        got_bq = ball_query_cuda(radii, BQ_NSAMPLE, xyz, centers)
        want_bq = pc.ball_query_msg_ref(radii, BQ_NSAMPLE, xyz, centers)
        same(got_bq, want_bq, f"ball query N={n} M={npoint} r={radii} S={BQ_NSAMPLE}")
        ms = cuda_ms(lambda: ball_query_cuda(radii, BQ_NSAMPLE, xyz, centers), 50)
        dev_ms = device_ms(lambda: ball_query_cuda(radii, BQ_NSAMPLE, xyz, centers), 20,
                           "ball_query_kernel")
        plain = cuda_ms(lambda: pc.ball_query_msg_ref(radii, BQ_NSAMPLE, xyz, centers), 5)
        # what this data needs: each distance once, up to the later of a
        # center's row stops, at 8 operations (3 sub, 3 mul, 2 add), plus one
        # compare per radius up to that radius's stop; beside it the bound of
        # the earlier count, one launch per radius with its own distances
        # (8 operations and a compare per pair)
        later, per_radius, mean_hits = examined_pairs(xyz, centers, radii, BQ_NSAMPLE, want_bq)
        io = B * n * 12 + B * npoint * 12
        per_radius_bound = sum(bound_ms(io + B * npoint * s * 4, pairs * 9)[0]
                               for s, pairs in zip(BQ_NSAMPLE, per_radius))
        bq_rows.append(row(f"B{B} N{n} M{npoint} r{radii} S{BQ_NSAMPLE}", ms, plain,
                           io + B * npoint * sum(BQ_NSAMPLE) * 4,
                           later * 8 + sum(per_radius), device_ms=dev_ms, mean_hits=mean_hits,
                           per_radius_bound_ms=per_radius_bound))
        # fused: bit for bit against its plain version and the separate kernels
        got_f = fps_bq_fused_cuda(xyz, npoint, radii, BQ_NSAMPLE)
        same(got_f, pc.fps_bq_fused_ref(xyz, npoint, radii, BQ_NSAMPLE),
             f"fused vs plain N={n} npoint={npoint}")
        same(got_f, (got, got_bq), f"fused vs separate kernels N={n} npoint={npoint}")
        ms = cuda_ms(lambda: fps_bq_fused_cuda(xyz, npoint, radii, BQ_NSAMPLE), 50)
        dev_ms = device_ms(lambda: fps_bq_fused_cuda(xyz, npoint, radii, BQ_NSAMPLE), 20,
                           "fps_bq_fused_kernel")
        plain = cuda_ms(lambda: pc.fps_bq_fused_ref(xyz, npoint, radii, BQ_NSAMPLE), 3)
        fps_round = fps_rows[-1]["us_per_round"]
        us_round = per_round(dev_ms, npoint)
        # each input and output once; the FPS rounds' distance rows (one more,
        # at 8 operations a point, for the last center) and one compare per
        # examined (center, point) pair and radius: the distance is shared
        n_bytes = B * n * 12 + B * npoint * 4 + B * npoint * sum(BQ_NSAMPLE) * 4
        n_ops = B * (npoint - 1) * n * 10 + B * n * 8 + sum(per_radius)
        fused_rows.append(row(f"B{B} N{n} npoint{npoint} r{radii} S{BQ_NSAMPLE}", ms, plain,
                              n_bytes, n_ops, device_ms=dev_ms, us_per_round=us_round,
                              round_over_fps=None if None in (us_round, fps_round)
                              else us_round / fps_round))
        xyz = centers

    # the training batch at each stage, where the kernels choose differently
    # (one lane per ball-query center at every stage); the fused kernel
    # against the same plain results
    train = object_clouds(gen, B_TRAIN, N_POINTS, dev)
    train = train - train.mean(dim=1, keepdim=True)
    for (n, npoint), radii in zip(FPS_SHAPES, BQ_RADII):
        want_idx = pc.farthest_point_sample_ref(train, npoint)
        same(fps_cuda(train, npoint), want_idx, f"FPS B={B_TRAIN} N={n}")
        centers = pc.gather_points(train, want_idx)
        want_bq = pc.ball_query_msg_ref(radii, BQ_NSAMPLE, train, centers)
        same(ball_query_cuda(radii, BQ_NSAMPLE, train, centers), want_bq,
             f"ball query B={B_TRAIN} N={n} M={npoint} r={radii}")
        same(fps_bq_fused_cuda(train, npoint, radii, BQ_NSAMPLE), (want_idx, want_bq),
             f"fused vs plain B={B_TRAIN} N={n} npoint={npoint}")
        train = centers

    # ties, unaligned N, npoint > N, exact boundary, empty balls, three
    # radii with r=0
    ties = torch.zeros(3, 100, 3, device=dev)
    ties[:, 50:] = 1.0
    odd = torch.randn(5, 777, 3, generator=gen, device=dev) * 0.1
    f32 = np.float32
    edge = torch.tensor([[[0.09998, 0.002, 0.0], [0.05, 0, 0], [0.5, 0, 0], [0.49, 0, 0]]],
                        device=dev)
    if f32(f32(f32(0.09998) ** 2) + f32(f32(0.002) ** 2)) != f32(0.1 * 0.1):
        raise AssertionError("the boundary point does not sit on r=0.1")
    origin = torch.zeros(1, 1, 3, device=dev)
    c77 = odd[:, :77].contiguous()
    cases = [
        ("fps ties, npoint > N", lambda: fps_cuda(ties, 150),
         lambda: pc.farthest_point_sample_ref(ties, 150)),
        ("fps N=777", lambda: fps_cuda(odd, 300), lambda: pc.farthest_point_sample_ref(odd, 300)),
        ("fps N=64 npoint=512", lambda: fps_cuda(odd[:, :64].contiguous(), 512),
         lambda: pc.farthest_point_sample_ref(odd[:, :64].contiguous(), 512)),
        ("bq N=777 M=77", lambda: ball_query_cuda((0.1, 0.3), (16, 32), odd, c77),
         lambda: pc.ball_query_msg_ref((0.1, 0.3), (16, 32), odd, c77)),
        ("bq empty balls", lambda: ball_query_cuda((0.01, 0.1), (8, 16), odd, odd[:, :40] + 5.0),
         lambda: pc.ball_query_msg_ref((0.01, 0.1), (8, 16), odd, odd[:, :40] + 5.0)),
        ("bq boundary r=0.1 and r=0.5", lambda: ball_query_cuda((0.1, 0.5), (4, 4), edge, origin),
         lambda: pc.ball_query_msg_ref((0.1, 0.5), (4, 4), edge, origin)),
        ("bq three radii with r=0",
         lambda: ball_query_cuda((0.05, 0.3, 0.0), (4, 32, 2), odd, c77),
         lambda: pc.ball_query_msg_ref((0.05, 0.3, 0.0), (4, 32, 2), odd, c77)),
    ]
    rng = np.random.RandomState(11)
    for b, n, m, radii, nsamples in ((4, 512, 256, (0.02, 0.04), (16, 32)),
                                     (3, 256, 128, (0.08, 0.16), (16, 32)),
                                     (2, 100, 64, (0.3,), (8,))):  # the JAX test's cases
        pts = torch.from_numpy((rng.randn(b, n, 3) * 0.1).astype(np.float32)).to(dev)
        cases.append((f"fused B{b} N{n} M{m}", lambda p=pts, m=m, r=radii, s=nsamples:
                      fps_bq_fused_cuda(p, m, r, s),
                      lambda p=pts, m=m, r=radii, s=nsamples: pc.fps_bq_fused_ref(p, m, r, s)))
    # npoint > N, and r=0: every ball empty (a center is a point of its cloud)
    small = odd[:, :64].contiguous()
    big = torch.randn(2, 8192, 3, generator=gen, device=dev) * 0.1  # the most points it takes
    radii8, nsamples8 = (0.01, 0.02, 0.04, 0.08, 0.16, 0.3, 0.0, 1.0), (3, 16, 32, 5, 33, 64, 2, 7)
    cases += [
        ("fused npoint > N, empty balls",
         lambda: fps_bq_fused_cuda(small, 512, (0.05, 1.0, 0.0), (4, 40, 2)),
         lambda: pc.fps_bq_fused_ref(small, 512, (0.05, 1.0, 0.0), (4, 40, 2))),
        ("fused boundary r=0.1", lambda: fps_bq_fused_cuda(torch.cat([origin, edge], 1), 3,
                                                          (0.1, 0.5), (4, 4)),
         lambda: pc.fps_bq_fused_ref(torch.cat([origin, edge], 1), 3, (0.1, 0.5), (4, 4))),
        ("fused N=777, eight radii", lambda: fps_bq_fused_cuda(odd, 100, radii8, nsamples8),
         lambda: pc.fps_bq_fused_ref(odd, 100, radii8, nsamples8)),
        ("fused N=33, npoint=1", lambda: fps_bq_fused_cuda(odd[:, :33].contiguous(), 1,
                                                          (0.05, 0.3), (4, 40)),
         lambda: pc.fps_bq_fused_ref(odd[:, :33].contiguous(), 1, (0.05, 0.3), (4, 40))),
        ("fused N=8192, eight radii", lambda: fps_bq_fused_cuda(big, 64, radii8, nsamples8),
         lambda: pc.fps_bq_fused_ref(big, 64, radii8, nsamples8)),
    ]
    for name, kern, plain in cases:
        same(kern(), plain(), name)
    print(f"kernels equal their plain versions at the 3 FPS and 3 two-radius ball-query "
          f"stage shapes at B={B} and at B={B_TRAIN}, the fused kernel at the 3 stage shapes "
          f"at both batches, and {len(cases)} edge cases", flush=True)
    return fps_rows, bq_rows, fused_rows, err


def make_pipeline(dev, **overrides):
    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.runners.serving import InferencePipeline
    from genpose_tpu_torch.utils.weights import perturb_

    cfg = Config(batch_size=B, eval_repeat_num=K, num_points=N_POINTS, T0=0.55,
                 sampling_steps=HEUN_STEPS).replace(**overrides)
    pipe = InferencePipeline(cfg, device=dev)
    # distinct non-zero weights for the two agents (zero tail outputs would
    # make every score 0): seeded perturbation on top of the seeded init
    perturb_(pipe.score_agent.model, seed=1)
    perturb_(pipe.energy_agent.model, seed=2)
    return pipe


def geometry_stages(cfg) -> int:
    """FPS (and ball-query) launches in one geometry pass of ``cfg``'s
    encoder: one per SA stage with centres, none for plain PointNet."""
    from genpose_tpu_torch.models.pointnet2 import CLS_MSG_CONFIGS

    if cfg.pts_encoder == "pointnet":
        return 0
    return sum(m is not None for m in CLS_MSG_CONFIGS[cfg.pointnet2_params]["NPOINTS"])


def drive(pipe, pts: np.ndarray, label: str):
    """Phase 4: one request through the pipeline with the counters read around it."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda

    chunks = -(-pts.shape[0] // pipe.bs)
    gen = torch.Generator(device=pipe.device).manual_seed(1)
    torch.cuda.synchronize()
    fps_cuda.launches = 0
    ball_query_cuda.launches = 0
    t0 = time.perf_counter()
    out = pipe.predict(pts, generator=gen)  # ends in host copies: synchronised
    seconds = time.perf_counter() - t0
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    per = geometry_stages(pipe.cfg) * chunks
    if launches != {"fps": per, "ball_query": per}:
        raise AssertionError(f"{label}: main path launches {launches}, expected "
                             f"{per} FPS and {per} ball query")
    n = pts.shape[0]
    want_shapes = {"pred_pose": (n, 7), "best_pose": (n, 7),
                   "sorted_hypotheses": (n, pipe.K, pipe.score_agent.pose_dim),
                   "energy": (n, pipe.K, 2)}
    for k, shape in want_shapes.items():
        if out[k].shape != shape or not np.isfinite(out[k]).all():
            raise AssertionError(f"{label}: {k} has shape {out[k].shape} or non-finite values")
    qn = np.linalg.norm(out["pred_pose"][:, :4], axis=1)
    if not np.allclose(qn, 1.0, atol=1e-4):
        raise AssertionError(f"{label}: pooled quaternions are not unit ({qn.min()}, {qn.max()})")
    return out, seconds, launches


def where_the_time_goes(pipe, pts: np.ndarray, label: str):
    """One more request, split by stage (host clock around each stage, with the
    device synchronised on both sides), then the same request under
    ``torch.profiler``: the device's busy share of the wall time and the
    kernels that take most of it."""
    with timing_calls({}, (pipe.score_agent, "pts_geometry",
                           "geometry (FPS + ball query + grouping)"),
                      (pipe.score_agent, "sample", "score encoder + sampler"),
                      (pipe.energy_agent, "get_energy", "energy encoder + head"),
                      (pipe.score_agent, "aggregate_hypotheses", "quaternion pooling")) as stages:
        t0 = time.perf_counter()
        pipe.predict(pts, generator=torch.Generator(device=pipe.device).manual_seed(1))
        total = (time.perf_counter() - t0) * 1e3
    split = ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
    print(f"stage split {label} (ms): {split}; whole request {total:.3f}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.predict(pts, generator=torch.Generator(device=pipe.device).manual_seed(1))
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        print(f"profiler {label}: no device time recorded; busy share not measured", flush=True)
        return {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    tops = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                     for e in top)
    n_launches = sum(e.count for e in kernels)
    print(f"profiler {label}: device busy {dev_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall = {dev_us / wall_us:.4f} (profiled); {n_launches} device kernels and "
          f"copies; top kernels: {tops}", flush=True)
    # device time of this port's own kernels in the request (no host issue time)
    ours = {name: sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
            for name, tag in (("fps", "fps_kernel"), ("ball_query", "ball_query_kernel"))}
    print(f"profiler {label}: device ms per request of the port's kernels {ours}", flush=True)
    return ours


def cpu_gpu_agreement(dev, label: str = "", **overrides):
    """Phase 5: a small batch on the card and on the CPU, same weights and
    noise (phase 16: under each new configuration's ``overrides``).

    Coordinates lie on a 2^-10 m grid, so the zero-centering mean (a sum of
    1024 grid values, divided by 1024) is exact in float32 on both devices
    whatever the summation order, and FPS and ball query see identical
    inputs.  What remains is the GEMM summation order (cuBLAS vs the CPU
    BLAS), carried through 20 Heun steps, the ranking and the 4x4 eigen-solve:
    ~1e-6 relative per product, held to CPU_GPU_TOL.
    """
    import dataclasses

    from genpose_tpu_torch.runners.serving import InferencePipeline

    small = dict(batch_size=2, eval_repeat_num=4, sampling_steps=20, **overrides)
    gpu = make_pipeline(dev, **small)
    cpu = InferencePipeline(gpu.cfg, device="cpu")
    cpu.score_agent.model.load_state_dict(gpu.score_agent.model.state_dict())
    cpu.energy_agent.model.load_state_dict(gpu.energy_agent.model.state_dict())
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        size=(8, gpu.score_agent.pose_dim)).astype(np.float32))
    sde = gpu.score_agent.sde

    def prior(shape, T=None, generator=None, device=None):
        return noise[:shape[0]].to(device) * sde.marginal_prob(None, T)[1]

    for pipe in (gpu, cpu):
        pipe.score_agent.sde = dataclasses.replace(sde, prior=prior)
    gen = torch.Generator(device=dev).manual_seed(2)
    # offsets on the same grid keep the cloud mean exact
    pts = object_clouds(gen, 2, N_POINTS, dev, grid=2.0 ** -10) + torch.tensor(
        [0.125, -0.0625, 0.75], device=dev)
    pts = pts.cpu().numpy()
    a, b = gpu.predict(pts), cpu.predict(pts)
    worst = 0.0
    for k in ("pred_pose", "best_pose", "sorted_hypotheses", "energy"):
        x, y = a[k], b[k]
        if k == "pred_pose":  # the pooled quaternion is an eigenvector: up to sign
            s = np.sign(np.sum(x[:, :4] * y[:, :4], axis=1, keepdims=True))
            x = np.concatenate([x[:, :4] * s, x[:, 4:]], axis=1)
        diff = float(np.max(np.abs(x - y) / (1.0 + np.abs(y))))
        worst = max(worst, diff)
        if diff > CPU_GPU_TOL:
            raise AssertionError(f"CUDA vs CPU{label} {k}: max scaled diff {diff} > {CPU_GPU_TOL}")
    print(f"CUDA vs CPU{label} (bs=2, K=4, 20 Heun steps): max |a-b|/(1+|b|) = {worst:.3e} "
          f"<= {CPU_GPU_TOL}", flush=True)
    return worst


def fused_geometry_path(dev, card):
    """Phase 4: the fused kernel's path, the three-stage geometry chain of
    ``genpose_tpu_torch/tools/bench_fused_geometry.py``, once with each arm
    and the counts read around it; then both arms timed."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_bq_fused_cuda, fps_cuda
    from genpose_tpu_torch.tools import bench_fused_geometry as bench

    gen = torch.Generator(device=dev).manual_seed(3)
    pts = object_clouds(gen, B, N_POINTS, dev)
    pts = pts - pts.mean(dim=1, keepdim=True)
    mods = {"fps": fps_cuda, "ball_query": ball_query_cuda, "fps_bq_fused": fps_bq_fused_cuda}
    outs, launches = {}, {}
    for use_fused in (True, False):
        torch.cuda.synchronize()
        for m in mods.values():
            m.launches = 0
        outs[use_fused] = bench.chain(pts, use_fused)
        torch.cuda.synchronize()
        launches[use_fused] = {k: m.launches for k, m in mods.items()}
    want = {True: {"fps": 0, "ball_query": 0, "fps_bq_fused": 3},
            False: {"fps": 3, "ball_query": 3, "fps_bq_fused": 0}}
    if launches != want:
        raise AssertionError(f"geometry chain launches {launches}, expected {want}")
    for (fi_f, bq_f), (fi_s, bq_s) in zip(outs[True], outs[False]):
        if not (torch.equal(fi_f, fi_s) and all(torch.equal(a, b) for a, b in zip(bq_f, bq_s))):
            raise AssertionError("the fused and separate arms of the chain disagree")
    times = bench.measure(pts, iters=16)
    # each arm's kernels' device time per chain, by the profiler (3 launches
    # of each kernel a chain)
    profiled = {use_fused: device_ms(lambda u=use_fused: bench.chain(pts, u), 4, tags, per_call=3)
                for use_fused, tags in ((True, "fps_bq_fused_kernel"),
                                        (False, ("fps_kernel", "ball_query_kernel")))}
    times["chain_fused_device_ms"] = profiled[True]
    times["chain_separate_device_ms"] = profiled[False]
    verdict = "win" if times["chain_fused_win_pct"] > 0 else "loss"
    print(f"fused geometry chain (B={B}, 3 stages): separate {times['chain_separate_ms']:.4f} ms, "
          f"fused {times['chain_fused_ms']:.4f} ms: a {verdict} of "
          f"{abs(times['chain_fused_win_pct']):.2f}% for the fused kernel; per stage "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items() if k.startswith("s"))
          + f"; device time per chain (profiled): fused kernel {_ms(profiled[True])}, "
          f"FPS + ball query {_ms(profiled[False])}; {card}", flush=True)
    return launches[True]["fps_bq_fused"], times, profiled[True]


def _raw_batches(rng, n, bs, n_pts):
    from genpose_tpu_torch.data.synthetic import synthetic_batch

    return [synthetic_batch(rng, bs=bs, n_pts=n_pts, n_model=n_pts) for _ in range(n)]


class StepMeter:
    """Wraps an agent method: host time around each call with the device
    synchronised on both sides, and the FPS / ball-query launches inside it."""

    def __init__(self, obj, name):
        from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda

        self.calls, self.obj, self.name = [], obj, name
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            f0, b0 = fps_cuda.launches, ball_query_cuda.launches
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append({"s": time.perf_counter() - t0, "fps": fps_cuda.launches - f0,
                               "ball_query": ball_query_cuda.launches - b0})
            return out

        setattr(obj, name, wrapper)  # an instance attribute shadows the method

    def close(self):
        delattr(self.obj, self.name)


def device_profile(fn, label, cpu: bool = True):
    """fn() once under torch.profiler: device busy share of the host wall
    time, device kernels and copies, device ms (None where no device time
    was recorded, which is printed).  ``cpu=False`` traces the device only:
    the host's ops go unrecorded, so the wall time carries less tracing
    overhead and a trace of ~50,000 kernels is read back in less time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us <= 0:
        print(f"profiler {label}: no device time recorded; busy share not measured", flush=True)
        return {"busy": None, "kernels": None, "device_ms": None, "wall_ms": wall_us / 1e3}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    ours = {tag: sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3
            for tag in ("fps_kernel", "ball_query_kernel")}
    n_kernels = sum(e.count for e in kernels)
    print(f"profiler {label}: device busy {dev_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"= {dev_us / wall_us:.4f}; {n_kernels} device kernels and copies; "
          "top: " + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                              for e in top)
          + f"; device ms of the port's kernels {ours}", flush=True)
    return {"busy": dev_us / wall_us, "kernels": n_kernels, "device_ms": dev_us / 1e3,
            "wall_ms": wall_us / 1e3}



def score_step_split(agent, raw, gen):
    """One call of ``agent.train_step`` cut into its stages: the functions
    the step calls are timed for this call (``timing_calls``), and the
    backward is what the step took beyond them."""
    from genpose_tpu_torch.data.process import process_batch
    from genpose_tpu_torch.models import pointnet2

    geo, enc = "geometry (FPS + ball query + grouping)", "encoder forward (train-mode BN)"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = process_batch(raw, agent.cfg.pose_mode, gen, agent.cfg.pts_aug, device=agent.device)
    torch.cuda.synchronize()
    prep = (time.perf_counter() - t0) * 1e3
    with timing_calls({}, (pointnet2, "sa_geometry", geo), (agent, "_encode", enc),
                      (agent, "_gf_loss", f"head + DSM loss forward ({agent.cfg.repeat_num} draws)"),
                      (agent.state, "apply_gradients", "clip + Adam + EMA"),
                      (agent, "train_step", "step")) as stages:
        agent.train_step(batch, gen)
    step = stages.pop("step")
    stages[enc] -= stages[geo]  # _encode's time includes the geometry's
    stages["backward (the rest of the step)"] = step - sum(stages.values())
    return {"process_batch + augmentation": prep, **stages}


def training_path(dev, card):
    """Phase 7: the training path at the released recipe's full width
    (``scripts/train_score.sh``, ``config.py:61-112``): ``train_score`` for
    SCORE_STEPS steps and its eval epoch, then ``train_energy(ranking=True)``
    for ENERGY_STEPS iterations with the trained score agent as the frozen
    teacher (K=5 candidates, ``ode_adaptive``)."""
    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners import trainer
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import latest_checkpoint, load_checkpoint
    from genpose_tpu_torch.utils.weights import perturb_

    out_dir = str(OUT_DIR / "train")
    rng = np.random.default_rng(0)
    result = {}

    # ---- score: the released recipe, defaults of Config --------------------
    scfg = Config(n_epochs=1, eval_freq=1, log_dir="score", seed=0)
    loader = _raw_batches(rng, SCORE_STEPS, scfg.batch_size, scfg.num_points)
    score = PoseAgent(scfg, "score", device=dev, steps_per_epoch=len(loader))
    perturb_(score.model, seed=11)  # non-zero tails, so every parameter trains from step 1
    params0 = {k: p.detach().clone() for k, p in score.params().items()}
    stats0 = {k: v.clone() for k, v in score.model.state_dict().items() if "running" in k}
    snaps = []
    meter = StepMeter(score, "train_step")
    orig = score.train_step  # the meter's wrapper

    def step_and_snapshot(*args, **kwargs):
        out = orig(*args, **kwargs)
        if len(snaps) < 2:
            snaps.append(({k: p.detach().clone() for k, p in score.params().items()},
                          {k: v.clone() for k, v in score.model.state_dict().items()
                           if "running" in k}))
        meter.calls[-1]["loss"] = float(out["gf"])
        return out

    score.train_step = step_and_snapshot
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps_cuda.launches = ball_query_cuda.launches = 0
    t0 = time.perf_counter()
    trainer.train_score(scfg, loader, loader[:1], score, out_dir=out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    delattr(score, "train_step")
    steps = meter.calls
    # the eval epoch samples the first batch of the train and the val loader
    want = {"fps": 3 * (SCORE_STEPS + 2), "ball_query": 3 * (SCORE_STEPS + 2)}
    if len(steps) != SCORE_STEPS or launches != want:
        raise AssertionError(f"train_score: {len(steps)} steps, launches {launches}, "
                             f"expected {SCORE_STEPS} steps and {want}")
    for n, st in enumerate(steps):
        if (st["fps"], st["ball_query"]) != (3, 3) or not np.isfinite(st["loss"]):
            raise AssertionError(f"score step {n}: {st}")
    (p1, s1), (p2, _) = snaps
    if not all(torch.equal(p1[k], params0[k]) for k in params0):
        raise AssertionError("the first step (lr 0) changed the params")
    if not all(not torch.equal(p2[k], params0[k]) for k in params0):
        raise AssertionError("the second step left some params as they were")
    if all(torch.equal(s1[k], stats0[k]) for k in stats0):
        raise AssertionError("the BatchNorm running statistics did not move")
    shadow, live = score.state.ema.shadow, score.params()
    if shadow is None or all(torch.equal(shadow[k], live[k]) for k in live):
        raise AssertionError("the EMA shadow equals the live params")
    s_step = float(np.median([st["s"] for st in steps[1:]]))
    result["score"] = {"steps": SCORE_STEPS, "losses": [st["loss"] for st in steps],
                       "s_per_step": s_step, "samples_per_s": scfg.batch_size / s_step,
                       "first_step_s": steps[0]["s"], "loop_wall_s": wall,
                       "peak_mem_gb": peak / 1e9, "launches": launches}
    print(f"train_score (bs={scfg.batch_size}, N={scfg.num_points}, repeat {scfg.repeat_num}, "
          f"Adam, {SCORE_STEPS} steps + eval epoch): {s_step:.4f} s per step = "
          f"{scfg.batch_size / s_step:.1f} samples/s (first step {steps[0]['s']:.3f} s); "
          f"losses {[round(x, 4) for x in result['score']['losses']]}; loop {wall:.2f} s; "
          f"peak memory {peak / 1e9:.3f} GB; launches {launches}; {card}", flush=True)

    # ---- energy with ranking: the trained score agent as frozen teacher ----
    ecfg = scfg.replace(sampler_mode=("ode_adaptive",), log_dir="energy", eval_freq=100)
    teacher = PoseAgent(ecfg, "score", device=dev)
    load_checkpoint(latest_checkpoint(trainer.results_dirs(scfg, out_dir)[0]), teacher,
                    load_model_only=True)
    eloader = _raw_batches(rng, ENERGY_STEPS, ecfg.batch_size, ecfg.num_points)
    energy = PoseAgent(ecfg, "energy", device=dev, steps_per_epoch=len(eloader))
    perturb_(energy.model, seed=12)
    e_params0 = {k: p.detach().clone() for k, p in energy.params().items()}
    sample_meter = StepMeter(teacher, "sample")
    step_meter = StepMeter(energy, "train_step_energy")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps_cuda.launches = ball_query_cuda.launches = 0
    t0 = time.perf_counter()
    trainer.train_energy(ecfg, eloader, eloader[:1], energy, teacher, ranking=True,
                         out_dir=out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    sample_meter.close()
    step_meter.close()
    iters = list(zip(sample_meter.calls, step_meter.calls))
    want = {"fps": 3 * ENERGY_STEPS, "ball_query": 3 * ENERGY_STEPS}
    if len(iters) != ENERGY_STEPS or launches != want:
        raise AssertionError(f"train_energy: {len(iters)} iterations, launches {launches}, "
                             f"expected {ENERGY_STEPS} and {want}")
    for n, (smp, stp) in enumerate(iters):
        if (smp["fps"] + stp["fps"], smp["ball_query"] + stp["ball_query"]) != (3, 3):
            raise AssertionError(f"energy iteration {n} did not share one geometry pass: "
                                 f"{smp}, {stp}")
    if energy.state.step != ENERGY_STEPS or teacher.state.step != 0:
        raise AssertionError("the energy agent must train and the teacher stay frozen")
    if all(torch.equal(p, e_params0[k]) for k, p in energy.params().items()):
        raise AssertionError("train_energy left the energy params as they were")
    shadow, live = energy.state.ema.shadow, energy.params()
    if all(torch.equal(shadow[k], live[k]) for k in live):
        raise AssertionError("the energy EMA shadow equals the live params")
    it_s = [smp["s"] + stp["s"] for smp, stp in iters]
    s_iter = float(np.median(it_s[1:]))
    result["energy"] = {"iterations": ENERGY_STEPS, "s_per_iteration": s_iter,
                        "samples_per_s": ecfg.batch_size / s_iter,
                        "sample_s": [c["s"] for c in sample_meter.calls],
                        "step_s": [c["s"] for c in step_meter.calls],
                        "loop_wall_s": wall, "peak_mem_gb": peak / 1e9, "launches": launches}
    print(f"train_energy ranking (bs={ecfg.batch_size}, K=5 candidates by ode_adaptive, "
          f"{ENERGY_STEPS} iterations): {s_iter:.4f} s per iteration = "
          f"{ecfg.batch_size / s_iter:.1f} samples/s; candidates "
          f"{[round(c['s'], 4) for c in sample_meter.calls]} s, energy step "
          f"{[round(c['s'], 4) for c in step_meter.calls]} s; loop {wall:.2f} s; "
          f"peak memory {peak / 1e9:.3f} GB; launches {launches}; {card}", flush=True)

    # ---- where the time goes: stage split and busy share --------------------
    split = score_step_split(score, loader[0], torch.Generator(device=dev).manual_seed(5))
    print("score step split (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; sum {sum(split.values()):.3f}; {card}", flush=True)
    from genpose_tpu_torch.data.process import process_batch

    gen = torch.Generator(device=dev).manual_seed(6)
    batch = process_batch(loader[1], scfg.pose_mode, gen, scfg.pts_aug, device=dev)
    busy_score = device_profile(lambda: score.train_step(batch, gen), "one score step")["busy"]

    def energy_iteration():
        cands, geom = teacher.sample(batch, generator=gen, repeat_num=5, return_geometry=True)
        energy.train_step_energy(batch, cands, gen, geometry=geom)

    busy_energy = device_profile(energy_iteration, "one energy iteration")["busy"]
    result["score"].update(split_ms=split, busy_share=busy_score)
    result["energy"].update(busy_share=busy_energy)
    return result


def _train_small(d, cfg, raws, draws, cands, t_int, zero_grads=False):
    """3 score steps and 2 energy steps on device ``d`` from seeded weights
    and the given batches and draws.  Returns the losses, the parameters
    before, and the state dicts after (on the CPU).  ``zero_grads``: the
    optimizer gets zeros for gradients (the check's control)."""
    from genpose_tpu_torch.data.process import process_batch
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.utils.weights import perturb_

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(d)  # noqa: E731
    agents = {"score": PoseAgent(cfg, "score", device=d), "energy": PoseAgent(cfg, "energy", device=d)}
    perturb_(agents["score"].model, seed=21)
    perturb_(agents["energy"].model, seed=22)
    before = {f"{m}.{k}": p.detach().cpu().clone() for m, a in agents.items()
              for k, p in a.params().items()}
    if zero_grads:
        for a in agents.values():
            apply = a.state.apply_gradients
            a.state.apply_gradients = lambda params, grads, _apply=apply: _apply(
                params, {k: torch.zeros_like(g) for k, g in grads.items()})
    losses = []
    for n in range(3):
        batch = process_batch(raws[n], device=d)
        losses.append(float(agents["score"].train_step(
            batch, noise=(f(draws[n][0]), f(draws[n][1])))["gf"]))
    for n in range(2):
        batch = process_batch(raws[n], device=d)
        out = agents["energy"].train_step_energy(
            batch, f(cands[n]) + batch["gt_pose"][:, None, :],
            noise=(f(draws[3 + n][0]), f(draws[3 + n][1])), t_int=torch.as_tensor(t_int[n]).to(d))
        losses += [float(out["gf"]), float(out["ranking"])]
    after = {f"{m}.{k}": v.cpu() for m, a in agents.items() for k, v in a.model.state_dict().items()}
    return losses, before, after


def _update_diff(run, ref):
    """The worst parameter's update difference: |(after - before) - (after_ref
    - before_ref)| over |after_ref - before_ref| (norms over the tensor), with
    the denominator held to at least 1e-4 of the largest update's norm."""
    upd = {k: run[2][k] - b for k, b in run[1].items()}
    want = {k: ref[2][k] - b for k, b in ref[1].items()}
    floor = 1e-4 * max(float(u.norm()) for u in want.values())
    return max(float((upd[k] - u).norm()) / max(float(u.norm()), floor)
               for k, u in want.items())


def training_cpu_gpu_agreement(dev):
    """Phase 8: 3 score steps and 2 energy steps on the card and on the CPU
    from the same weights, batches, draws and candidates.

    Coordinates lie on a 2^-10 m grid and N = 128, so the cloud centers are
    exact on both devices and the geometry is identical (the kernels equal
    their plain versions).  What remains is the summation order of the
    GEMMs (cuBLAS against the CPU BLAS), ~1e-6 relative per product, which
    the encoder's float32 gradients amplify (train-mode BatchNorm over few
    rows, max-pool choices): the JAX package and the port on the CPU give
    gradients up to 5% apart by a leaf's norm
    (tests/test_torch_training.py::test_step_gradients_match_jax).  SGD's
    update is lr times the gradient, so each parameter's update (after -
    before) is held against the CPU's relative to that update's norm, at
    TRAIN_UPDATE_RTOL; a missing or sign-flipped gradient is off by 1 or 2.
    The losses are held at rtol TRAIN_LOSS_RTOL, and every float tensor of
    the state (params and BatchNorm statistics) at rtol 1e-3 / atol
    TRAIN_PARAM_ATOL.  A control run on the card whose optimizer gets zeroed
    gradients must fail the update check.
    """
    from genpose_tpu_torch.config import Config

    cfg = Config(num_points=128, batch_size=4, repeat_num=2, warmup=1, optimizer="SGD")
    rng = np.random.default_rng(4)
    raws = _raw_batches(rng, 3, cfg.batch_size, cfg.num_points)
    for raw in raws:
        raw["pcl_in"] = (np.round(raw["pcl_in"] * 1024) / 1024).astype(np.float32)
    draws = [(rng.uniform(1e-5, 1.0, (2, 4, 1)), rng.normal(size=(2, 4, 9))) for _ in range(5)]
    cands = [rng.normal(size=(4, 3, 9)) * 0.3 for _ in range(2)]
    t_int = [rng.integers(1, 10, (4, 1)) for _ in range(2)]
    args = (cfg, raws, draws, cands, t_int)
    gpu, cpu = _train_small(dev, *args), _train_small(torch.device("cpu"), *args)
    (lg, _, sg), (lc, _, sc) = gpu, cpu
    loss_diff = float(np.max(np.abs(np.array(lg) - np.array(lc)) / np.abs(np.array(lc))))
    if not np.allclose(lg, lc, rtol=TRAIN_LOSS_RTOL, atol=0):
        raise AssertionError(f"CUDA vs CPU training losses {lg} vs {lc}")
    worst = 0.0
    for k, v in sc.items():
        if v.dtype != torch.float32:
            continue
        excess = (sg[k] - v).abs() - (TRAIN_PARAM_ATOL + 1e-3 * v.abs())
        worst = max(worst, float((sg[k] - v).abs().max()))
        if (excess > 0).any():
            raise AssertionError(f"CUDA vs CPU training: {k} differs by "
                                 f"{float((sg[k] - v).abs().max())}")
    upd = _update_diff(gpu, cpu)
    if upd > TRAIN_UPDATE_RTOL:
        raise AssertionError(f"CUDA vs CPU training: parameter updates differ by {upd} "
                             f"of their norm > {TRAIN_UPDATE_RTOL}")
    control = _update_diff(_train_small(dev, *args, zero_grads=True), cpu)
    if control <= TRAIN_UPDATE_RTOL:
        raise AssertionError(f"the update check passes a run with zeroed gradients ({control})")
    print(f"CUDA vs CPU training (3 score + 2 energy steps, bs=4, N=128, SGD): losses max "
          f"relative difference {loss_diff:.3e} <= {TRAIN_LOSS_RTOL}; params and BN statistics "
          f"max |a-b| {worst:.3e} (bound {TRAIN_PARAM_ATOL} + 1e-3 |b|); worst parameter "
          f"update {upd:.3e} of its norm <= {TRAIN_UPDATE_RTOL}; control with zeroed "
          f"gradients {control:.3e} > {TRAIN_UPDATE_RTOL}", flush=True)
    return loss_diff, worst, upd, control


def eval_config(nocs: str, result_dir: str, **overrides):
    """The evaluation runners' configuration of the released model
    (``scripts/eval_single.sh``: K=50, T0=0.55, batch 192, the default
    Heun-500 sampler) on the synthetic tree ``nocs``."""
    from genpose_tpu_torch.config import Config

    return Config(data_path=nocs, result_dir=result_dir, test_source="real_test",
                  num_points=N_POINTS, eval_repeat_num=K, T0=EVAL_T0,
                  batch_size=B_TRAIN).replace(**overrides)


def eval_agents(cfg, dev):
    """Score and energy agents with the serving phase's seeded, perturbed weights."""
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.utils.weights import perturb_

    score, energy = PoseAgent(cfg, "score", device=dev), PoseAgent(cfg, "energy", device=dev)
    perturb_(score.model, seed=1)
    perturb_(energy.model, seed=2)
    return score, energy


def hold_path_geometry(pts, label):
    """FPS and ball query against their plain versions, bit for bit, along
    the light encoder's three stages on clouds a driven path gives them."""
    from genpose_tpu_torch.ops import pointcloud as pc
    from genpose_tpu_torch.ops.ball_query_cuda import ball_query_cuda
    from genpose_tpu_torch.ops.fps_cuda import fps_cuda

    xyz = pts.contiguous()
    for (_, npoint), radii in zip(FPS_SHAPES, BQ_RADII):
        idx = pc.farthest_point_sample_ref(xyz, npoint)
        if not torch.equal(fps_cuda(xyz, npoint), idx):
            raise AssertionError(f"{label}: FPS != plain at N={xyz.shape[1]}")
        centers = pc.gather_points(xyz, idx)
        got = ball_query_cuda(radii, BQ_NSAMPLE, xyz, centers)
        want = pc.ball_query_msg_ref(radii, BQ_NSAMPLE, xyz, centers)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: ball query != plain at N={xyz.shape[1]}")
        xyz = centers
    return f"B{pts.shape[0]} N{pts.shape[1]}"


def near_gt_results(src: str, out_dir: str, seed: int = 0) -> str:
    """A copy of the results pkl ``src`` whose hypotheses lie within 1 degree
    and 0.5 cm of each instance's GT (the synthetic detections are the GT
    labels, instance for instance)."""
    import pickle

    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    with open(src, "rb") as f:
        data = pickle.load(f)
    for entry in data.values():
        res = entry["result"]
        hyps = res["multi_hypothesis_pred_RTs"]
        for i in range(hyps.shape[0]):
            gt = np.asarray(res["gt_RTs"][i], np.float64)
            R = gt[:3, :3] / np.cbrt(np.linalg.det(gt[:3, :3]))
            for k in range(hyps.shape[1]):
                w = rng.normal(size=3)
                w *= np.radians(rng.uniform(0, 1)) / np.linalg.norm(w)
                hyps[i, k] = np.eye(4)
                hyps[i, k, :3, :3] = Rotation.from_rotvec(w).as_matrix() @ R
                hyps[i, k, :3, 3] = gt[:3, 3] + rng.uniform(-0.0029, 0.0029, 3)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(out_dir) / "results_with_energy.pkl", "wb") as f:
        pickle.dump(data, f)
    return out_dir


def present_class_map(table_dir: str, results_pkl: str, degree: int = 10, shift: float = 5):
    """Mean pose mAP at (degree, shift) over the classes present in the GT."""
    import pickle

    with open(Path(table_dir) / "mAP_Acc.pkl", "rb") as f:
        tables = pickle.load(f)
    with open(results_pkl, "rb") as f:
        data = pickle.load(f)
    present = sorted({int(c) for e in data.values() for c in e["result"]["gt_class_ids"]})
    d, s = tables["degree_thres_list"].index(degree), tables["shift_thres_list"].index(shift)
    return float(tables["pose_aps"][present, d, s].mean()), present


def eval_stages_2_3(cfg, score, energy, seg, inf_dir, chunks, label):
    """Stages 2 and 3 of ``evaluation_single`` into ``inf_dir``, with the FPS
    and ball-query launches read around each stage and each chunk, and the
    frozen dispatches around each stage.  Returns (seconds, launches,
    dispatches) by stage."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners import evaluation_single as ev
    from genpose_tpu_torch.training import frozen

    meters = {"stage 2": StepMeter(score, "sample"), "stage 3": StepMeter(energy, "get_energy")}
    secs, launches, dispatches = {}, {}, {}
    try:
        for stage, run in (("stage 2", lambda: ev.inference_pose(cfg, score, seg, inf_dir)),
                           ("stage 3", lambda: ev.inference_energy(cfg, energy, inf_dir))):
            torch.cuda.synchronize()
            fps_cuda.launches = ball_query_cuda.launches = frozen.dispatches = 0
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs[stage] = time.perf_counter() - t0
            launches[stage] = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
            dispatches[stage] = frozen.dispatches
    finally:
        for m in meters.values():
            m.close()
    for stage, m in meters.items():
        per_chunk = [(c["fps"], c["ball_query"]) for c in m.calls]
        want = {"fps": 3 * chunks, "ball_query": 3 * chunks}
        if len(per_chunk) != chunks or set(per_chunk) != {(3, 3)} or launches[stage] != want:
            raise AssertionError(f"evaluation {label} {stage}: per-chunk launches {per_chunk}, "
                                 f"total {launches[stage]}, expected 3 + 3 in each of {chunks} "
                                 f"chunks")
    return secs, launches, dispatches


def evaluation_path(dev, card):
    """Phase 9: ``evaluation_single``'s four stages at the released model's
    full width on a synthetic Real/test tree of EVAL_SCENES scenes at
    640x480, with the launch counts read around stages 2 and 3; then stage 4
    on its own from near-GT hypotheses.  The agents are not frozen: this is
    the eager arm of phase 12."""
    import pickle
    import shutil

    from genpose_tpu_torch.data.synthetic import (make_synthetic_mrcnn_results,
                                                  make_synthetic_nocs_dir)
    from genpose_tpu_torch.runners import evaluation_single as ev

    root = OUT_DIR / "eval"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    nocs = make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1,
                                   n_real_scenes=EVAL_SCENES, seed=0)
    make_synthetic_mrcnn_results(nocs, str(root / "single"), "real_test")
    tree_s = time.perf_counter() - t0
    cfg = eval_config(nocs, str(root / "single"))
    score, energy = eval_agents(cfg, dev)
    base = root / "single" / "evaluation_results"
    seg, inf_dir = str(base / "segmentation_results_real_test.pkl"), str(base / "real_test_repeat_50")

    secs = {}
    t0 = time.perf_counter()
    ev.detect_mrcnn_results(cfg, seg)
    secs["stage 1"] = time.perf_counter() - t0
    _, categorized = ev.unpack_data(cfg, seg)
    largest = max(categorized.values(), key=lambda d: len(d["pts"]))
    instances = sum(len(d["pts"]) for d in categorized.values())
    chunks = sum(-(-len(d["pts"]) // cfg.batch_size) for d in categorized.values())
    # a chunk as stages 2-3 see it: padded to the batch size
    chunk = {k: ev.pad_rows(v, cfg.batch_size)
             for k, v in ev.zero_center_batch(largest["pts"], dev).items()}
    held = hold_path_geometry(chunk["zero_mean_pts"], "evaluation chunk")

    stage_secs, launches, dispatches = eval_stages_2_3(cfg, score, energy, seg, inf_dir, chunks,
                                                       "eager")
    if any(dispatches.values()):
        raise AssertionError(f"evaluation eager: frozen dispatches {dispatches}")
    secs.update(stage_secs)
    t0 = time.perf_counter()
    headline = ev.evaluate(cfg, inf_dir)
    ev.write_headline(inf_dir, headline)
    secs["stage 4"] = time.perf_counter() - t0

    with open(Path(inf_dir) / "results_with_energy.pkl", "rb") as f:
        results = pickle.load(f)
    for key, entry in results.items():
        res, valid = entry["result"], entry["valid_inst"]
        rts, energy_k = res["multi_hypothesis_pred_RTs"][valid], res["energy"][valid]
        if (rts.shape[1:] != (K, 4, 4) or not np.isfinite(rts).all()
                or not np.isfinite(energy_k).all() or (np.diff(energy_k, axis=1) > 0).any()):
            raise AssertionError(f"evaluation: {key} holds malformed hypotheses or energies")
    poses_s = instances / secs["stage 2"]
    print(f"evaluation (Real/test, {EVAL_SCENES} synthetic scenes at 640x480, {instances} "
          f"instances in {chunks} chunks, each padded to {cfg.batch_size}: "
          f"{chunks * cfg.batch_size / instances:.1f}x the rows of the instances; N={N_POINTS}, "
          f"K={K}, T0={EVAL_T0}, {cfg.sampling_steps} Heun steps): tree {tree_s:.3f} s; "
          + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items())
          + f"; stage 2 {poses_s:.2f} poses/s; launches per chunk FPS 3 + ball query 3 in "
          f"stage 2 ({launches['stage 2']}) and stage 3 ({launches['stage 3']}); kernels held "
          f"against their plain versions at {held}; {card}", flush=True)
    print(f"evaluation headline mAP (random weights, so about 0): "
          f"{ {k: round(float(v), 4) for k, v in headline.items()} }", flush=True)

    near = near_gt_results(str(Path(inf_dir) / "results_with_energy.pkl"), str(root / "near_gt"))
    ev.evaluate(cfg, near)
    table_dir = Path(near) / "results" / cfg.pooling_mode / cfg.ranker
    mean_map, present = present_class_map(table_dir, str(Path(near) / "results_with_energy.pkl"))
    if mean_map < 0.99:
        raise AssertionError(f"stage 4 on near-GT hypotheses: 10deg5cm mAP {mean_map} < 0.99 "
                             f"over classes {present}")
    print(f"stage 4 on near-GT hypotheses (within 1 deg, 0.5 cm): mean 10deg5cm mAP "
          f"{100 * mean_map:.2f} over the classes present {present}", flush=True)
    ctx = {"cfg": cfg, "seg": seg, "inf_dir": inf_dir, "chunk": chunk, "root": root}
    return {"instances": instances, "chunks": chunks, "seconds": secs, "tree_s": tree_s,
            "stage2_poses_per_s": poses_s, "launches": launches,
            "padded_rows_per_instance": chunks * cfg.batch_size / instances,
            "headline": {k: float(v) for k, v in headline.items()},
            "near_gt_10d5cm": mean_map}, nocs, (score, energy), ctx


def tracking_path(dev, card, nocs, agents, frozen_arm=False, compute_dtype="float32",
                  **overrides):
    """Phase 10: ``evaluation_tracking.main_tracking`` (T0=0.15) at full width
    on the phase-9 tree, the launch counts and the pooled poses read around
    each frame; then one frame profiled.  ``main_tracking`` freezes its
    agents: phase 10 is the eager arm, with ``freeze`` turned into a no-op on
    the two agents for the run; phase 12 runs the frozen arm
    (``frozen_arm``), as a user calls it, and phase 13 the same with
    ``--compute_dtype bfloat16`` agents; phase 17 runs both arms under the
    EDM sampler (``overrides`` of the config).  Returns the summary, the
    pooled poses of every frame and the metrics."""
    from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners import evaluation_single as ev
    from genpose_tpu_torch.runners import evaluation_tracking as et
    from genpose_tpu_torch.training import frozen
    from genpose_tpu_torch.utils.tracking import add_noise_to_RT, srt_to_pose9d

    arm = ("frozen" if frozen_arm else "eager") + (
        "" if compute_dtype == "float32" else f" {compute_dtype}") + (
        f" {overrides['sampler_mode'][0]}" if "sampler_mode" in overrides else "")
    result_dir = str(OUT_DIR / "eval" / f"tracking_{arm.replace(' ', '_')}")
    make_synthetic_mrcnn_results(nocs, result_dir, "real_test", tracking=True)
    cfg = eval_config(nocs, result_dir, T0=TRACK_T0, compute_dtype=compute_dtype, **overrides)
    score, energy = agents
    frames, poses, real = [], [], et.track_frame

    def metered(*args, **kwargs):
        torch.cuda.synchronize()
        f0, b0, d0 = fps_cuda.launches, ball_query_cuda.launches, frozen.dispatches
        t0 = time.perf_counter()
        R, t = real(*args, **kwargs)
        torch.cuda.synchronize()
        frames.append({"s": time.perf_counter() - t0, "fps": fps_cuda.launches - f0,
                       "ball_query": ball_query_cuda.launches - b0,
                       "dispatches": frozen.dispatches - d0,
                       "objects": int(args[3]["zero_mean_pts"].shape[0])})
        poses.append(torch.cat([R.flatten(1), t], 1).cpu().numpy())
        return R, t

    et.track_frame = metered
    if not frozen_arm:
        for a in agents:
            a.freeze = lambda a=a: a  # an instance attribute shadows the method
    try:
        torch.cuda.synchronize()
        fps_cuda.launches = ball_query_cuda.launches = frozen.dispatches = 0
        t0 = time.perf_counter()
        metrics = et.main_tracking(cfg, tracking=True, T0=TRACK_T0, device=dev,
                                   score_agent=score, energy_agent=energy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        et.track_frame = real
        if not frozen_arm:
            for a in agents:
                del a.freeze
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    want_dispatches = 2 if frozen_arm else 0  # sample + get_energy per frame
    if (not frames or {(f["fps"], f["ball_query"]) for f in frames} != {(3, 3)}
            or launches != {"fps": 3 * len(frames), "ball_query": 3 * len(frames)}
            or {f["dispatches"] for f in frames} != {want_dispatches}):
        raise AssertionError(f"tracking {arm}: frames {frames}, launches {launches}: expected "
                             f"FPS 3, ball query 3 and {want_dispatches} frozen dispatches a "
                             f"frame")
    for name, m in metrics.items():
        if not np.isfinite(np.asarray(m["mean_error"], np.float64)).all():
            raise AssertionError(f"tracking: non-finite mean error for {name}")

    with open(Path(nocs) / "Real" / "test_list.txt") as f:
        first = sorted("Real/" + line.strip() for line in f)[0]
    frame = et.extract_single_frame_data(cfg, first, np.random.default_rng(0))
    batch = ev.zero_center_batch(frame["pts"], dev)
    held = hold_path_geometry(batch["zero_mean_pts"], "tracking frame")
    gen = torch.Generator(device=dev).manual_seed(3)
    gt = torch.as_tensor(np.asarray(frame["gt_pose"], np.float32), device=dev)
    init = srt_to_pose9d(add_noise_to_RT(gt, generator=gen))
    init[:, -3:] -= batch["pts_center"]
    prof = device_profile(lambda: et.track_frame(cfg, score, energy, batch, init, TRACK_T0, gen),
                          f"one tracking frame, {arm}")
    frame_s = [f["s"] for f in frames]
    print(f"tracking {arm} (Real/test, {len(frames)} frames, "
          f"{sum(f['objects'] for f in frames)} objects; N={N_POINTS}, K={K}, T0={TRACK_T0}, "
          f"sde {cfg.sde_mode}, {cfg.sampling_steps} steps of {cfg.sampler_mode[0]}): "
          f"{len(frames) / wall:.3f} frames/s ({wall:.3f} s; "
          f"a frame's device chain median {np.median(frame_s):.4f} s); launches per frame FPS 3 "
          f"+ ball query 3 ({launches}), frozen dispatches {want_dispatches} a frame; kernels "
          f"held against their plain versions at {held}; {card}", flush=True)
    print(f"tracking {arm} metrics (random weights): " + "; ".join(
        f"{k}: mean error {np.round(np.asarray(m['mean_error'], np.float64), 3).tolist()}, "
        f"5d5cm {m['5d5cm_acc']:.4f}" for k, m in metrics.items()), flush=True)
    return {"frames": len(frames), "frames_per_s": len(frames) / wall, "wall_s": wall,
            "frame_s_median": float(np.median(frame_s)), "launches": launches,
            "busy_share": prof["busy"], "frame_device_kernels": prof["kernels"],
            "frame_device_ms": prof["device_ms"]}, poses, metrics


def _scaled_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size else 0.0


def eval_cpu_gpu_agreement(dev):
    """Phase 11: evaluation stages 2-4 and 3 tracking frames on a small tree
    (3 scenes; N=128, K=4, 8 Heun steps), once on the card and once on the
    CPU with the same weights, the same prior rows and the same pose noise.

    Stage 1 runs once, on the host; its clouds (and the tracking frames')
    are rounded to a 2^-10 m grid so that the zero-centering mean is exact
    on both devices and the kernels see what the plain versions see.  What
    remains is the GEMM summation order, held to CPU_GPU_TOL scaled by
    magnitude.  The mAP tables of the two results pkls must be identical."""
    import dataclasses
    import pickle

    from genpose_tpu_torch.data.synthetic import (make_synthetic_mrcnn_results,
                                                  make_synthetic_nocs_dir)
    from genpose_tpu_torch.runners import evaluation_single as ev
    from genpose_tpu_torch.runners import evaluation_tracking as et

    root = OUT_DIR / "eval_small"
    nocs = make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=1, n_real_scenes=3,
                                   seed=1)
    small = dict(num_points=128, eval_repeat_num=4, sampling_steps=8, batch_size=4)
    cfg = eval_config(nocs, str(root / "single"), **small)
    make_synthetic_mrcnn_results(nocs, cfg.result_dir, "real_test")
    seg = str(root / "single" / "seg.pkl")
    ev.detect_mrcnn_genpose(cfg, seg)
    grid = lambda p: (np.round(np.asarray(p) * 1024) / 1024).astype(np.float32)  # noqa: E731
    with open(seg, "rb") as f:
        data = pickle.load(f)
    for entry in data.values():
        entry["valid_pts"] = [grid(p) for p in entry["valid_pts"]]
    with open(seg, "wb") as f:
        pickle.dump(data, f)

    gpu = eval_agents(cfg, dev)
    cpu = eval_agents(cfg, torch.device("cpu"))
    for g, c in zip(gpu, cpu):
        c.model.load_state_dict(g.model.state_dict())
    noise = torch.from_numpy(np.random.default_rng(7).normal(size=(64, 9)).astype(np.float32))
    sde = gpu[0].sde

    def prior(shape, T=None, generator=None, device=None):
        return noise[:shape[0]].to(device) * sde.marginal_prob(None, T)[1]

    for s, _ in (gpu, cpu):
        s.sde = dataclasses.replace(sde, prior=prior)

    out, worst = {}, {}
    for side, (s, e) in (("cuda", gpu), ("cpu", cpu)):
        d = str(root / "single" / side)
        ev.inference_pose(cfg, s, seg, d)
        ev.inference_energy(cfg, e, d)
        ev.evaluate(cfg, d)
        out[side] = d
    for name, keys in (("results_wo_energy.pkl", ("multi_hypothesis_pred_RTs",)),
                       ("results_with_energy.pkl", ("multi_hypothesis_pred_RTs", "energy"))):
        with open(Path(out["cuda"]) / name, "rb") as fa, open(Path(out["cpu"]) / name, "rb") as fb:
            a, b = pickle.load(fa), pickle.load(fb)
        for k in keys:
            worst[f"{name}:{k}"] = max(_scaled_diff(a[p]["result"][k], b[p]["result"][k])
                                       for p in a)
    table = lambda d: Path(d) / "results" / cfg.pooling_mode / cfg.ranker / "mAP_Acc.pkl"  # noqa
    with open(table(out["cuda"]), "rb") as fa, open(table(out["cpu"]), "rb") as fb:
        ta, tb = pickle.load(fa), pickle.load(fb)
    for k in ("iou_aps", "pose_aps", "iou_acc", "pose_acc"):
        if not np.array_equal(ta[k], tb[k], equal_nan=True):
            raise AssertionError(f"CUDA vs CPU evaluation: {k} tables differ")

    # tracking: 3 frames, the grid-rounded clouds, fixed pose-noise draws
    tcfg = eval_config(nocs, str(root / "tracking"), T0=TRACK_T0, **small)
    make_synthetic_mrcnn_results(nocs, tcfg.result_dir, "real_test", tracking=True)
    rng = np.random.default_rng(8)
    draws = [tuple(torch.from_numpy(x.astype(np.float32)) for x in (
        np.abs(rng.normal(size=8)) * np.pi / 36, rng.normal(size=8) * 0.03,
        rng.normal(size=(8, 3)), rng.normal(size=(8, 4)))) for _ in range(3)]
    real_extract, real_track = et.extract_single_frame_data, et.track_frame
    pooled = {"cuda": [], "cpu": []}
    running = []  # the side whose frames are being tracked

    def extract(*args):
        frame = real_extract(*args)
        if frame is not None:
            frame["pts"] = [grid(p) for p in frame["pts"]]
        return frame

    def track(*args, **kwargs):
        R, t = real_track(*args, **kwargs)
        pooled[running[-1]].append(torch.cat([R.flatten(1), t], 1).cpu().numpy())
        return R, t

    et.extract_single_frame_data, et.track_frame = extract, track
    try:
        for side, (s, e) in (("cuda", gpu), ("cpu", cpu)):
            running.append(side)
            et.main_tracking(tcfg, tracking=True, T0=TRACK_T0, device=s.device, score_agent=s,
                             energy_agent=e, noise_draws=lambda n, b: tuple(x[:b] for x in draws[n]))
    finally:
        et.extract_single_frame_data, et.track_frame = real_extract, real_track
    if len(pooled["cuda"]) != 3 or len(pooled["cpu"]) != 3:
        raise AssertionError(f"CUDA vs CPU tracking: {len(pooled['cuda'])} / "
                             f"{len(pooled['cpu'])} frames, expected 3")
    worst["tracking pooled poses"] = max(_scaled_diff(a, b)
                                         for a, b in zip(pooled["cuda"], pooled["cpu"]))
    bad = {k: v for k, v in worst.items() if v > CPU_GPU_TOL}
    if bad:
        raise AssertionError(f"CUDA vs CPU evaluation / tracking: {bad} > {CPU_GPU_TOL}")
    print("CUDA vs CPU evaluation (3 scenes, N=128, K=4, 8 Heun steps) and tracking (3 "
          "frames): max |a-b|/(1+|b|) " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" <= {CPU_GPU_TOL}; mAP tables identical", flush=True)
    return worst


FROZEN_TOL = 1e-6  # phase 12: frozen against eager, |a-b|/(1+|b|), where not bit for bit


def _agreement(label: str, a: dict, b: dict) -> str:
    """Hold two dicts of arrays (frozen, eager) to each other: bit for bit,
    or else within FROZEN_TOL scaled.  Says which."""
    if all(np.array_equal(a[k], b[k]) for k in b):
        return "bit for bit"
    worst = max(_scaled_diff(a[k], b[k]) for k in b)
    if worst > FROZEN_TOL:
        raise AssertionError(f"{label}: frozen vs eager max |a-b|/(1+|b|) {worst} > {FROZEN_TOL}")
    return f"not bit for bit, max |a-b|/(1+|b|) {worst:.3e} <= {FROZEN_TOL}"


@contextlib.contextmanager
def _traced():
    """The program's tracing on for a freeze phase: yields the list that
    receives the phase's span records when it ends."""
    from genpose_tpu_torch.utils import trace

    records = []
    trace.drain()
    trace.enable()
    try:
        yield records
    finally:
        trace.disable()
        records.extend(trace.drain()[0])


def _graph_stats(records):
    """Warm-up and capture (+ instantiate) seconds and graph count of each
    frozen program captured in a traced phase: its ``frozen.capture`` span,
    less the ``frozen.warmup`` span inside it."""
    warmups = {r["parent"]: r for r in records if r["name"] == "frozen.warmup"}
    out = {}
    for r in records:
        if r["name"] != "frozen.capture":
            continue
        a, w = r["attrs"], warmups.get(r["id"])
        warmup_s = (w["end_ns"] - w["start_ns"]) / 1e9 if w is not None else 0.0
        out[f"{a['mode']} {a['kind']} {a['rows']}x{a['K']}"] = {
            "warmup_s": warmup_s, "capture_s": (r["end_ns"] - r["start_ns"]) / 1e9 - warmup_s,
            "graphs": a["graphs"]}
    return out


def frozen_serving(dev, card, pts: np.ndarray):
    """Phase 12, serving: at full width under each sampler, a request eagerly
    and then through ``freeze()`` from the same generator state; then, under
    RK45, a weight change must end the frozen path and a new ``freeze()``
    equal eager under the new weights."""
    from genpose_tpu_torch.training import frozen
    from genpose_tpu_torch.utils.weights import perturb_

    result = {}
    for sampler in ("ode", "ode_adaptive"):
        pipe = make_pipeline(dev, sampler_mode=(sampler,)).warmup()
        chunks = -(-pts.shape[0] // pipe.bs)

        def request():
            return pipe.predict(pts, generator=torch.Generator(device=dev).manual_seed(1))

        eager, eager_s, _ = drive(pipe, pts, f"{sampler} eager")
        eager_prof = device_profile(request, f"serving {sampler}, eager request")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        with _traced() as captured:
            pipe.freeze().warmup()
        freeze_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        held_mb = (torch.cuda.memory_reserved() - reserved0) / 2 ** 20
        frozen.dispatches = 0
        got, frozen_s, launches = drive(pipe, pts, f"{sampler} frozen")
        dispatches = frozen.dispatches
        if dispatches != 2 * chunks:
            raise AssertionError(f"serving {sampler} frozen: {dispatches} frozen dispatches, "
                                 f"expected {2 * chunks}")
        how = _agreement(f"serving {sampler}", got, eager)
        frozen_prof = device_profile(request, f"serving {sampler}, frozen request")
        graphs = _graph_stats(captured)
        result[sampler] = {"eager_s": eager_s, "frozen_s": frozen_s,
                           "eager_poses_per_s": B / eager_s, "frozen_poses_per_s": B / frozen_s,
                           "eager_profile": eager_prof, "frozen_profile": frozen_prof,
                           "freeze_and_warmup_s": freeze_s, "graphs": graphs,
                           "held_mb": held_mb, "launches": launches, "dispatches": dispatches,
                           "agreement": how}
        print(f"frozen serving {sampler} (bs={B}, K={K}, N={N_POINTS}): eager {eager_s:.4f} s "
              f"= {B / eager_s:.2f} poses/s, frozen {frozen_s:.4f} s = {B / frozen_s:.2f} "
              f"poses/s; busy {eager_prof['busy']} -> {frozen_prof['busy']}, device kernels "
              f"{eager_prof['kernels']} -> {frozen_prof['kernels']} per request; freeze + "
              f"warmup {freeze_s:.3f} s, programs {graphs}; device memory held by the frozen "
              f"programs {held_mb:.1f} MiB (reserved); launches {launches}, frozen dispatches "
              f"{dispatches}; frozen vs eager {how}; {card}", flush=True)

        if sampler == "ode_adaptive":
            perturb_(pipe.score_agent.model, seed=21)
            if pipe.score_agent.frozen_programs() is not None:
                raise AssertionError("perturb_ left the score agent's frozen programs in use")
            frozen.dispatches = 0
            new_eager, _, _ = drive(pipe, pts, "RK45 after perturb_")
            eager_dispatches = frozen.dispatches  # the energy agent's, still frozen
            pipe.freeze()
            frozen.dispatches = 0
            new_frozen, _, _ = drive(pipe, pts, "RK45 frozen again")
            if (eager_dispatches, frozen.dispatches) != (chunks, 2 * chunks):
                raise AssertionError(f"frozen dispatches after perturb_ {eager_dispatches}, "
                                     f"after freeze() {frozen.dispatches}")
            if np.array_equal(new_eager["sorted_hypotheses"], got["sorted_hypotheses"]):
                raise AssertionError("perturb_ did not change the request's hypotheses")
            how_new = _agreement("serving RK45 after perturb_", new_frozen, new_eager)
            result[sampler]["after_weight_change"] = how_new
            print(f"frozen serving: after perturb_ of the score weights the score agent ran "
                  f"eagerly ({eager_dispatches} frozen dispatches, the energy agent's); a new "
                  f"freeze() equals eager under the new weights, {how_new}", flush=True)
        del pipe
        torch.cuda.empty_cache()
    return result


def frozen_evaluation(dev, card, evaluation, ctx, agents):
    """Phase 12, evaluation: stages 2-3 on phase 9's tree with both agents
    frozen, as ``evaluation_single.main`` runs them, against phase 9's eager
    results; stage 4 of both must give identical mAP tables.  One padded
    stage-2 chunk is profiled in each arm."""
    import pickle

    from genpose_tpu_torch.runners import evaluation_single as ev

    cfg, chunk, score, energy = ctx["cfg"], ctx["chunk"], *agents
    chunks = evaluation["chunks"]
    frozen_dir = str(ctx["root"] / "single" / "frozen")

    def one_chunk():
        score.sample(chunk, generator=torch.Generator(device=dev).manual_seed(cfg.seed),
                     repeat_num=K, num_steps=cfg.sampling_steps, T0=cfg.T0)

    eager_prof = device_profile(one_chunk, "one stage-2 chunk, eager")
    with _traced() as captured:
        score.freeze()
        energy.freeze()
        secs, launches, dispatches = eval_stages_2_3(cfg, score, energy, ctx["seg"], frozen_dir,
                                                     chunks, "frozen")
    if dispatches != {"stage 2": chunks, "stage 3": chunks}:
        raise AssertionError(f"evaluation frozen: dispatches {dispatches}, expected {chunks} "
                             f"in each stage")
    frozen_prof = device_profile(one_chunk, "one stage-2 chunk, frozen")
    ev.evaluate(cfg, frozen_dir)

    def load(d, name):
        with open(Path(d) / name, "rb") as f:
            return pickle.load(f)

    agreement = {}
    for name, keys in (("results_wo_energy.pkl", ("multi_hypothesis_pred_RTs",)),
                       ("results_with_energy.pkl", ("multi_hypothesis_pred_RTs", "energy"))):
        a, b = load(frozen_dir, name), load(ctx["inf_dir"], name)
        agreement[name] = _agreement(f"evaluation {name}", {
            f"{p}:{k}": a[p]["result"][k] for p in a for k in keys},
            {f"{p}:{k}": b[p]["result"][k] for p in b for k in keys})
    tables = [load(Path(d) / "results" / cfg.pooling_mode / cfg.ranker, "mAP_Acc.pkl")
              for d in (frozen_dir, ctx["inf_dir"])]
    for k in ("iou_aps", "pose_aps", "iou_acc", "pose_acc"):
        if not np.array_equal(tables[0][k], tables[1][k], equal_nan=True):
            raise AssertionError(f"evaluation frozen vs eager: {k} tables differ")
    eager_secs = evaluation["seconds"]
    instances = evaluation["instances"]
    graphs = _graph_stats(captured)
    print(f"frozen evaluation ({instances} instances in {chunks} chunks padded to "
          f"{cfg.batch_size}): stage 2 eager {eager_secs['stage 2']:.4f} s = "
          f"{instances / eager_secs['stage 2']:.2f} poses/s, frozen {secs['stage 2']:.4f} s = "
          f"{instances / secs['stage 2']:.2f} poses/s (capture included); stage 3 eager "
          f"{eager_secs['stage 3']:.4f} s, frozen {secs['stage 3']:.4f} s; one chunk busy "
          f"{eager_prof['busy']} -> {frozen_prof['busy']}, device kernels "
          f"{eager_prof['kernels']} -> {frozen_prof['kernels']}; programs {graphs}; launches "
          f"{launches}, frozen dispatches {dispatches}; frozen vs eager {agreement}; mAP tables "
          f"identical; {card}", flush=True)
    return {"seconds": secs, "stage2_poses_per_s": instances / secs["stage 2"],
            "launches": launches, "dispatches": dispatches, "eager_chunk_profile": eager_prof,
            "frozen_chunk_profile": frozen_prof, "graphs": graphs, "agreement": agreement}


def frozen_tracking(dev, card, nocs, agents, eager, eager_poses, eager_metrics):
    """Phase 12, tracking: ``main_tracking`` as a user calls it (both agents
    frozen) on phase 10's frames, against phase 10's eager run."""
    with _traced() as captured:
        result, poses, metrics = tracking_path(dev, card, nocs, agents, frozen_arm=True)
    if len(poses) != len(eager_poses):
        raise AssertionError(f"tracking: {len(poses)} frozen frames, {len(eager_poses)} eager")
    how = _agreement("tracking pooled poses", {n: p for n, p in enumerate(poses)},
                     {n: p for n, p in enumerate(eager_poses)})
    for name, m in eager_metrics.items():
        got = metrics[name]
        if got["5d5cm_acc"] != m["5d5cm_acc"] or _scaled_diff(got["mean_error"],
                                                               m["mean_error"]) > FROZEN_TOL:
            raise AssertionError(f"tracking metrics of {name}: frozen {got}, eager {m}")
    graphs = _graph_stats(captured)
    print(f"frozen tracking: {result['frames_per_s']:.3f} frames/s against "
          f"{eager['frames_per_s']:.3f} eager (capture included); a frame's chain median "
          f"{result['frame_s_median']:.4f} s against {eager['frame_s_median']:.4f} s; one frame "
          f"busy {eager['busy_share']} -> {result['busy_share']}, device kernels "
          f"{eager['frame_device_kernels']} -> {result['frame_device_kernels']}; programs "
          f"{graphs}; pooled poses {how}; metrics equal; {card}", flush=True)
    result.update(graphs=graphs, agreement=how)
    return result


# phase 13: bfloat16 against float32 on the same prior rows, per hypothesis:
# the budget of tests/test_bf16.py (rotation mean and max in degrees, the
# largest translation difference over the mean translation, the largest
# energy difference over the largest energy)
BF16_BUDGET = {"mean_deg": 1.0, "max_deg": 3.0, "trans": 0.05, "energy": 0.05}
CPU_GPU_BF16_TOL = 1e-2  # phase 13: bfloat16 on the card against the CPU, scaled


def _rotation_deg(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Angles (degrees) between the rotations of two pose sets [..., 9]."""
    from genpose_tpu_torch.ops.pose import get_rot_matrix

    Ra = get_rot_matrix(a.reshape(-1, 9)[:, :6], "rot_matrix").double()
    Rb = get_rot_matrix(b.reshape(-1, 9)[:, :6], "rot_matrix").double()
    tr = torch.einsum("bij,bij->b", Ra, Rb)
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1) / 2, -1, 1))).cpu().numpy()


def _bf16_gaps(pipes, pts: np.ndarray, sampler: str):
    """The two pipelines' score agents sample the same clouds from the same
    generator state (the same prior rows), and both energy agents score the
    float32 samples: per-hypothesis rotation angles, translation and energy
    gaps, bfloat16 against float32."""
    dev = pipes["float32"].device
    x = torch.from_numpy(pts).to(dev)
    center = x.mean(dim=1)
    batch = {"zero_mean_pts": x - center[:, None], "pts_center": center}
    cfg = pipes["float32"].cfg
    samples = {dt: p.score_agent.sample(batch, torch.Generator(device=dev).manual_seed(1),
                                        repeat_num=K, sampler=sampler,
                                        num_steps=cfg.sampling_steps, T0=cfg.T0)
               for dt, p in pipes.items()}
    s32, s16 = samples["float32"], samples["bfloat16"]
    e32, e16 = (pipes[dt].energy_agent.get_energy(batch, s32, T=1e-5)
                for dt in ("float32", "bfloat16"))
    if s16.dtype != torch.float32 or e16.dtype != torch.float32:
        raise AssertionError(f"bf16 {sampler}: samples {s16.dtype}, energies {e16.dtype}")
    ang = _rotation_deg(s32, s16)
    return {"mean_deg": float(ang.mean()), "max_deg": float(ang.max()),
            "trans": float((s32[..., -3:] - s16[..., -3:]).abs().max()
                           / s32[..., -3:].abs().mean()),
            "energy": float((e32 - e16).abs().max() / e32.abs().max())}


def bf16_serving(dev, card, pts: np.ndarray, f32_arms: dict):
    """Phase 13, serving: at full width under each sampler, a
    ``compute_dtype="bfloat16"`` pipeline with the serving weights, eagerly
    and then frozen (bit for bit); the float32 pipeline frozen beside it
    (phase 12 timed its arms in this call); bfloat16 against float32 per
    hypothesis within BF16_BUDGET; the pooled poses' gaps reported."""
    from genpose_tpu_torch.training import frozen

    result = {}
    for sampler in ("ode", "ode_adaptive"):
        pipes = {dt: make_pipeline(dev, sampler_mode=(sampler,), compute_dtype=dt)
                 for dt in ("float32", "bfloat16")}
        pipe = pipes["bfloat16"].warmup()
        chunks = -(-pts.shape[0] // pipe.bs)

        def request():
            return pipe.predict(pts, generator=torch.Generator(device=dev).manual_seed(1))

        eager, eager_s, _ = drive(pipe, pts, f"bf16 {sampler} eager")
        eager_prof = device_profile(request, f"serving bf16 {sampler}, eager request")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        with _traced() as captured:
            pipe.freeze().warmup()
        freeze_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        held_mb = (torch.cuda.memory_reserved() - reserved0) / 2 ** 20
        frozen.dispatches = 0
        got, frozen_s, launches = drive(pipe, pts, f"bf16 {sampler} frozen")
        if frozen.dispatches != 2 * chunks:
            raise AssertionError(f"serving bf16 {sampler} frozen: {frozen.dispatches} frozen "
                                 f"dispatches, expected {2 * chunks}")
        if not all(np.array_equal(got[k], eager[k]) for k in eager):
            raise AssertionError(f"serving bf16 {sampler}: frozen differs from eager")
        frozen_prof = device_profile(request, f"serving bf16 {sampler}, frozen request")
        graphs = _graph_stats(captured)

        ref, _, _ = drive(pipes["float32"].freeze().warmup(), pts, f"f32 {sampler} frozen")
        gaps = _bf16_gaps(pipes, pts, sampler)
        over = {k: v for k, v in gaps.items() if v > BF16_BUDGET[k]}
        if over:
            raise AssertionError(f"serving bf16 {sampler} against f32: {gaps} over {BF16_BUDGET}")
        pooled = {"max_deg": float(np.degrees(2 * np.arccos(np.clip(np.abs(np.sum(
                      got["pred_pose"][:, :4] * ref["pred_pose"][:, :4], axis=1)), 0, 1))).max()),
                  "trans": float(np.abs(got["pred_pose"][:, 4:] - ref["pred_pose"][:, 4:]).max()
                                 / np.abs(ref["pred_pose"][:, 4:]).mean())}
        f32 = f32_arms[sampler]
        result[sampler] = {"eager_s": eager_s, "frozen_s": frozen_s,
                           "eager_poses_per_s": B / eager_s, "frozen_poses_per_s": B / frozen_s,
                           "eager_profile": eager_prof, "frozen_profile": frozen_prof,
                           "freeze_and_warmup_s": freeze_s, "graphs": graphs, "held_mb": held_mb,
                           "launches": launches, "against_f32": gaps, "pooled_against_f32": pooled,
                           "f32_frozen_s": f32["frozen_s"], "f32_eager_s": f32["eager_s"]}
        print(f"bf16 serving {sampler} (bs={B}, K={K}, N={N_POINTS}): eager {eager_s:.4f} s = "
              f"{B / eager_s:.2f} poses/s, frozen {frozen_s:.4f} s = {B / frozen_s:.2f} poses/s "
              f"(f32 in phase 12: eager {f32['eager_s']:.4f} s, frozen {f32['frozen_s']:.4f} s); "
              f"busy {eager_prof['busy']} -> {frozen_prof['busy']}, device ms "
              f"{eager_prof['device_ms']} -> {frozen_prof['device_ms']}, device kernels "
              f"{eager_prof['kernels']} -> {frozen_prof['kernels']} per request; freeze + warmup "
              f"{freeze_s:.3f} s, programs {graphs}; device memory held by the frozen programs "
              f"{held_mb:.1f} MiB (reserved); launches {launches}; frozen vs eager bit for bit; "
              f"against f32 per hypothesis {gaps} (budget {BF16_BUDGET}); pooled poses "
              f"{pooled}; {card}", flush=True)
        del pipe, pipes
        torch.cuda.empty_cache()
    return result


def bf16_cpu_gpu_agreement(dev):
    """Phase 13: bfloat16 on the card against the CPU (bs=2, K=4, 20 Heun
    steps, the grid clouds and prior rows of phase 6): the samples, and the
    energies of the CPU's samples, within CPU_GPU_BF16_TOL scaled.  cuBLAS
    and the CPU GEMMs both accumulate in float32, in other orders, so a
    bfloat16 rounding flips now and then."""
    import dataclasses

    from genpose_tpu_torch.runners.serving import InferencePipeline

    gpu = make_pipeline(dev, batch_size=2, eval_repeat_num=4, sampling_steps=20,
                        compute_dtype="bfloat16")
    cpu = InferencePipeline(gpu.cfg, device="cpu")
    cpu.score_agent.model.load_state_dict(gpu.score_agent.model.state_dict())
    cpu.energy_agent.model.load_state_dict(gpu.energy_agent.model.state_dict())
    noise = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 9)).astype(np.float32))
    sde = gpu.score_agent.sde

    def prior(shape, T=None, generator=None, device=None):
        return noise[:shape[0]].to(device) * sde.marginal_prob(None, T)[1]

    gen = torch.Generator(device=dev).manual_seed(2)
    pts = object_clouds(gen, 2, N_POINTS, dev, grid=2.0 ** -10) + torch.tensor(
        [0.125, -0.0625, 0.75], device=dev)
    out = {}
    for name, pipe in (("cuda", gpu), ("cpu", cpu)):
        pipe.score_agent.sde = dataclasses.replace(sde, prior=prior)
        x = pts.to(pipe.device)
        center = x.mean(dim=1)
        batch = {"zero_mean_pts": x - center[:, None], "pts_center": center}
        out[name] = (batch, pipe.score_agent.sample(batch, repeat_num=4, T0=gpu.cfg.T0))
    cpu_samples = out["cpu"][1]
    energies = {name: pipe.energy_agent.get_energy(out[name][0], cpu_samples.to(pipe.device),
                                                   T=1e-5).cpu().numpy()
                for name, pipe in (("cuda", gpu), ("cpu", cpu))}
    diffs = {"samples": _scaled_diff(out["cuda"][1].cpu().numpy(), cpu_samples.numpy()),
             "energies": _scaled_diff(energies["cuda"], energies["cpu"])}
    if max(diffs.values()) > CPU_GPU_BF16_TOL:
        raise AssertionError(f"bf16 CUDA vs CPU: {diffs} > {CPU_GPU_BF16_TOL}")
    print(f"bf16 CUDA vs CPU (bs=2, K=4, 20 Heun steps): max |a-b|/(1+|b|) {diffs} <= "
          f"{CPU_GPU_BF16_TOL}", flush=True)
    return diffs


def bf16_training(dev, card, f32_score):
    """Phase 13, training: ``train_score`` at the released recipe (bs=192,
    N=1024) under the supported mix, ``--compute_dtype bfloat16
    --encoder_f32_stages -2``, for SCORE_STEPS steps and its eval epoch:
    finite losses, FPS 3 + ball query 3 per step, every parameter, BatchNorm
    statistic, moment and EMA shadow tensor float32 after it."""
    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners import trainer
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.utils.weights import perturb_

    cfg = Config(n_epochs=1, eval_freq=1, log_dir="score_bf16", seed=0,
                 compute_dtype="bfloat16", encoder_f32_stages=-2)
    loader = _raw_batches(np.random.default_rng(0), SCORE_STEPS, cfg.batch_size, cfg.num_points)
    agent = PoseAgent(cfg, "score", device=dev, steps_per_epoch=len(loader))
    perturb_(agent.model, seed=11)
    meter = StepMeter(agent, "train_step")
    orig = agent.train_step

    def step(*args, **kwargs):
        out = orig(*args, **kwargs)
        meter.calls[-1]["loss"] = float(out["gf"])
        return out

    agent.train_step = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps_cuda.launches = ball_query_cuda.launches = 0
    t0 = time.perf_counter()
    trainer.train_score(cfg, loader, loader[:1], agent, out_dir=str(OUT_DIR / "train"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    del agent.train_step
    steps = meter.calls
    want = {"fps": 3 * (SCORE_STEPS + 2), "ball_query": 3 * (SCORE_STEPS + 2)}
    if len(steps) != SCORE_STEPS or launches != want:
        raise AssertionError(f"bf16 train_score: {len(steps)} steps, launches {launches}, "
                             f"expected {SCORE_STEPS} steps and {want}")
    for n, st in enumerate(steps):
        if (st["fps"], st["ball_query"]) != (3, 3) or not np.isfinite(st["loss"]):
            raise AssertionError(f"bf16 score step {n}: {st}")
    state = [*agent.model.parameters(), *agent.model.buffers(),
             *agent.state.ema.shadow.values(),
             *(t for m in agent.state.opt_state.values() for t in m.values())]
    if any(t.dtype != torch.float32 for t in state if t.is_floating_point()):
        raise AssertionError("bf16 training left a parameter or statistic below float32")
    s_step = float(np.median([st["s"] for st in steps[1:]]))
    result = {"steps": SCORE_STEPS, "losses": [st["loss"] for st in steps], "s_per_step": s_step,
              "samples_per_s": cfg.batch_size / s_step, "first_step_s": steps[0]["s"],
              "loop_wall_s": wall, "peak_mem_gb": peak / 1e9, "launches": launches,
              "f32_s_per_step": f32_score["s_per_step"],
              "f32_peak_mem_gb": f32_score["peak_mem_gb"]}
    print(f"bf16 train_score (bfloat16, encoder_f32_stages -2; bs={cfg.batch_size}, "
          f"N={cfg.num_points}, repeat {cfg.repeat_num}, Adam, {SCORE_STEPS} steps + eval "
          f"epoch): {s_step:.4f} s per step = {cfg.batch_size / s_step:.1f} samples/s (f32 "
          f"in phase 7: {f32_score['s_per_step']:.4f} s); losses "
          f"{[round(x, 4) for x in result['losses']]}; peak memory {peak / 1e9:.3f} GB (f32 "
          f"{f32_score['peak_mem_gb']:.3f}); launches {launches}; {card}", flush=True)
    return result


def bf16_evaluation_tracking(dev, card, evaluation, frozen_eval, ctx, nocs):
    """Phase 13, evaluation and tracking: stages 2-3 of phase 9's tree with
    ``--compute_dtype bfloat16`` agents frozen (as ``evaluation_single.main``
    runs them), then ``main_tracking`` on phase 10's frames with them."""
    import pickle

    from genpose_tpu_torch.runners import evaluation_single as ev

    cfg = ctx["cfg"].replace(compute_dtype="bfloat16")
    score, energy = eval_agents(cfg, dev)
    chunks, instances = evaluation["chunks"], evaluation["instances"]
    out_dir = str(ctx["root"] / "single" / "bf16_frozen")
    with _traced() as captured:
        score.freeze()
        energy.freeze()
        secs, launches, dispatches = eval_stages_2_3(cfg, score, energy, ctx["seg"], out_dir,
                                                     chunks, "bf16 frozen")
    if dispatches != {"stage 2": chunks, "stage 3": chunks}:
        raise AssertionError(f"evaluation bf16: dispatches {dispatches}, expected {chunks} each")
    chunk_prof = device_profile(
        lambda: score.sample(ctx["chunk"], repeat_num=K, num_steps=cfg.sampling_steps, T0=cfg.T0,
                             generator=torch.Generator(device=dev).manual_seed(cfg.seed)),
        "one stage-2 chunk, frozen bfloat16")
    with open(Path(out_dir) / "results_with_energy.pkl", "rb") as f:
        results = pickle.load(f)
    for key, entry in results.items():
        res, valid = entry["result"], entry["valid_inst"]
        rts, energy_k = res["multi_hypothesis_pred_RTs"][valid], res["energy"][valid]
        if (rts.shape[1:] != (K, 4, 4) or not np.isfinite(rts).all()
                or not np.isfinite(energy_k).all() or (np.diff(energy_k, axis=1) > 0).any()):
            raise AssertionError(f"evaluation bf16: {key} holds malformed hypotheses or energies")
    headline = ev.evaluate(cfg, out_dir)
    f32 = frozen_eval["seconds"]
    print(f"bf16 evaluation frozen ({instances} instances in {chunks} chunks padded to "
          f"{cfg.batch_size}): stage 2 {secs['stage 2']:.4f} s = "
          f"{instances / secs['stage 2']:.2f} poses/s (capture included; f32 frozen in phase 12 "
          f"{f32['stage 2']:.4f} s), stage 3 {secs['stage 3']:.4f} s (f32 {f32['stage 3']:.4f} "
          f"s); one chunk busy {chunk_prof['busy']}, device ms {chunk_prof['device_ms']} "
          f"(f32 {frozen_eval['frozen_chunk_profile']['device_ms']}), device kernels "
          f"{chunk_prof['kernels']}; launches {launches}, frozen dispatches {dispatches}; "
          f"headline mAP (random "
          f"weights) { {k: round(float(v), 4) for k, v in headline.items()} }; {card}",
          flush=True)
    tracking, _, _ = tracking_path(dev, card, nocs, (score, energy), frozen_arm=True,
                                   compute_dtype="bfloat16")
    return {"evaluation": {"seconds": secs, "stage2_poses_per_s": instances / secs["stage 2"],
                           "launches": launches, "dispatches": dispatches,
                           "frozen_chunk_profile": chunk_prof,
                           "graphs": _graph_stats(captured)},
            "tracking": tracking}


# phase 14: the samplers of the new paths, each at the released model's full
# width; EDM at its reference step count (``cond_edm_sampler``)
SAMPLER_ARMS = {"pc": dict(sampler_mode=("pc",)),
                "vp_ode": dict(sde_mode="vp"),
                "edm": dict(sde_mode="edm", sampler_mode=("edm",), sampling_steps=18)}
LIKELIHOOD_STEPS = 50  # phase 14: a few poses' PF-ODE likelihood on the card and the CPU
# phase 14: the times at which the energies of the CPU's samples are held,
# card against CPU.  Serving ranks at t=1e-5; under VP the std there is
# sqrt(1 - exp(-1e-6)), which float32 cancels to ~2 digits on any device
# (a last-ulp difference of exp moves it by ~6 %), so VP is held at t=0.5
# and its t=1e-5 difference is printed only.
ENERGY_TS = {"pc": (1e-5,), "vp_ode": (0.5,), "edm": (1e-5,)}


def _pinned_prior(sde, rows: torch.Tensor):
    """``sde`` whose prior returns the first rows of ``rows`` as its standard
    normal draw (scaled by the SDE's own prior), on the asked device."""
    import dataclasses

    def prior(shape, T=None, generator=None, device=None):
        kw = {} if T is None else {"T": T}
        return sde.prior(shape, noise=rows[:shape[0]].to(device), **kw)

    return dataclasses.replace(sde, prior=prior)


def released_checkpoint_route(dev, card, pts: np.ndarray):
    """Phase 14 (1): the serving phase's seeded weights written as released
    GenPose ``.pth`` files (``upstream_state_dict``), converted by
    ``genpose_tpu_torch/tools/port_torch_ckpt.py`` and served by
    ``InferencePipeline(score_ckpt=, energy_ckpt=)`` on the card: its
    predictions must equal the directly loaded pipeline's bit for bit."""
    from genpose_tpu_torch.runners.serving import InferencePipeline
    from genpose_tpu_torch.tools import port_torch_ckpt
    from genpose_tpu_torch.utils.weights import to_jax_variables

    src = make_pipeline(dev).warmup()
    out_dir = OUT_DIR / "released"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    t0 = time.perf_counter()
    for mode, agent in (("score", src.score_agent), ("energy", src.energy_agent)):
        pth = out_dir / f"{mode}.pth"
        torch.save({"model_state_dict": upstream_state_dict(*to_jax_variables(agent.model)),
                    "clock": {"epoch": 1, "minibatch": 0, "step": 0}}, pth)
        paths[mode] = port_torch_ckpt.main(["--input", str(pth), "--output",
                                            str(out_dir / f"{mode}_port"), "--posenet_mode", mode])
    convert_s = time.perf_counter() - t0
    pipe = InferencePipeline(src.cfg, device=dev, score_ckpt=paths["score"],
                             energy_ckpt=paths["energy"]).warmup()
    want, _, _ = drive(src, pts, "directly loaded")
    got, seconds, launches = drive(pipe, pts, "from released .pth")
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"released .pth route: {k} differs from the directly loaded "
                                 f"pipeline (max {_scaled_diff(got[k], want[k])})")
    print(f"released .pth -> port (upstream layout, both models converted in "
          f"{convert_s:.3f} s): the pipeline loaded from the converted checkpoints equals the "
          f"directly loaded one bit for bit (bs={B}, K={K}, N={N_POINTS}, {HEUN_STEPS} Heun "
          f"steps; {seconds:.4f} s, launches {launches}); {card}", flush=True)
    return {"convert_s": convert_s, "seconds": seconds, "launches": launches,
            "agreement": "bit for bit"}


def new_sampler_paths(dev, card, pts: np.ndarray):
    """Phase 14 (2): one request each under PC (VE, 500 steps), VP Heun-500
    and EDM (18 steps) at full width: seconds, poses/s, busy share, device
    kernels and the FPS / ball-query launches read around the request."""
    result = {}
    for name, overrides in SAMPLER_ARMS.items():
        pipe = make_pipeline(dev, **overrides)
        t0 = time.perf_counter()
        pipe.warmup()
        warm = time.perf_counter() - t0
        _, seconds, launches = drive(pipe, pts, name)
        prof = device_profile(
            lambda: pipe.predict(pts, generator=torch.Generator(device=dev).manual_seed(1)),
            f"serving {name}", cpu=False)
        result[name] = {"seconds": seconds, "poses_per_s": B / seconds, "warmup_s": warm,
                        "steps": pipe.cfg.sampling_steps, "launches": launches, "profile": prof}
        print(f"new sampler path {name} (bs={B}, K={K}, N={N_POINTS}, sde {pipe.cfg.sde_mode}, "
              f"sampler {pipe.sampler}, {pipe.cfg.sampling_steps} steps): {seconds:.4f} s per "
              f"request = {B / seconds:.2f} poses/s (warmup {warm:.2f} s); busy "
              f"{prof['busy']}, device ms {prof['device_ms']}, {prof['kernels']} device kernels; "
              f"launches {launches}; {card}", flush=True)
        del pipe
        torch.cuda.empty_cache()
    return result


def new_sampler_cpu_gpu_agreement(dev, card):
    """Phase 14 (3): the card against the CPU, same weights, grid clouds
    (phase 6) and injected draws: PC (VE), VP Heun and EDM samples (bs=2,
    K=4, 20 steps; EDM 18), the energies of the CPU's samples, and the
    PF-ODE likelihood of 2 poses, a hypothesis of each cloud
    (LIKELIHOOD_STEPS steps, exact divergence), with the FPS and ball-query
    launches of the card's likelihood call."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners.serving import InferencePipeline

    t_phase = time.perf_counter()
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.normal(size=(8, 9)).astype(np.float32))
    steps = 20
    draws = {"pc": {"noise": tuple(torch.from_numpy(rng.normal(size=(steps, 8, 9)).astype(
                 np.float32)) for _ in range(2))},
             "edm": {"latents": rows}}
    gen = torch.Generator(device=dev).manual_seed(2)
    pts = (object_clouds(gen, 2, N_POINTS, dev, grid=2.0 ** -10)
           + torch.tensor([0.125, -0.0625, 0.75], device=dev)).cpu()
    diffs = {}
    for name, overrides in SAMPLER_ARMS.items():
        small = dict(overrides, batch_size=2, eval_repeat_num=4,
                     sampling_steps=18 if name == "edm" else steps)
        gpu = make_pipeline(dev, **small)
        cpu = InferencePipeline(gpu.cfg, device="cpu")
        cpu.score_agent.model.load_state_dict(gpu.score_agent.model.state_dict())
        cpu.energy_agent.model.load_state_dict(gpu.energy_agent.model.state_dict())
        out = {}
        for where, pipe in (("cuda", gpu), ("cpu", cpu)):
            agent = pipe.score_agent
            agent.sde = _pinned_prior(agent.sde, rows)
            x = pts.to(pipe.device)
            center = x.mean(dim=1)
            batch = {"zero_mean_pts": x - center[:, None], "pts_center": center}
            kw = {k: (tuple(t.to(pipe.device) for t in v) if isinstance(v, tuple)
                      else v.to(pipe.device)) for k, v in draws.get(name, {}).items()}
            out[where] = (batch, agent.sample(batch, repeat_num=4, T0=gpu.cfg.T0,
                                              sampler=pipe.sampler,
                                              num_steps=gpu.cfg.sampling_steps, **kw))
        cpu_samples = out["cpu"][1]
        diffs[name] = {"samples": _scaled_diff(out["cuda"][1].cpu().numpy(), cpu_samples.numpy())}
        for T in ENERGY_TS[name]:
            e = [p.energy_agent.get_energy(out[w][0], cpu_samples.to(p.device), T=T).cpu().numpy()
                 for w, p in (("cuda", gpu), ("cpu", cpu))]
            diffs[name][f"energies_t{T:g}"] = _scaled_diff(*e)
        if name == "vp_ode":  # reported, not held: see ENERGY_TS
            e = [p.energy_agent.get_energy(out[w][0], cpu_samples.to(p.device), T=1e-5)
                 for w, p in (("cuda", gpu), ("cpu", cpu))]
            vp_energy_t1e5 = _scaled_diff(e[0].cpu().numpy(), e[1].numpy())
        if name == "pc":  # the likelihood under the VE score model of this arm
            poses = cpu_samples[:, 0].clone()
            poses[:, -3:] -= out["cpu"][0]["pts_center"]
            fps_cuda.launches = ball_query_cuda.launches = 0
            t0 = time.perf_counter()
            z_gpu, bits_gpu = gpu.score_agent.likelihood(out["cuda"][0], poses.to(dev),
                                                         num_steps=LIKELIHOOD_STEPS)
            torch.cuda.synchronize()
            lik_s = time.perf_counter() - t0
            lik_launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
            if lik_launches != {"fps": 3, "ball_query": 3}:
                raise AssertionError(f"likelihood launches {lik_launches}, expected 3 + 3")
            z_cpu, bits_cpu = cpu.score_agent.likelihood(out["cpu"][0], poses,
                                                         num_steps=LIKELIHOOD_STEPS)
            if not torch.isfinite(bits_gpu).all():
                raise AssertionError(f"likelihood bits not finite: {bits_gpu}")
            diffs["likelihood"] = {
                "latent": _scaled_diff(z_gpu.cpu().numpy(), z_cpu.numpy()),
                "bits": _scaled_diff(bits_gpu.cpu().numpy(), bits_cpu.numpy())}
            likelihood = {"seconds": lik_s, "steps": LIKELIHOOD_STEPS, "poses": 2,
                          "bits": bits_gpu.cpu().tolist(), "launches": lik_launches}
        del gpu, cpu
        torch.cuda.empty_cache()
    worst = max(v for d in diffs.values() for v in d.values())
    if worst > CPU_GPU_TOL:
        raise AssertionError(f"new samplers CUDA vs CPU: {diffs} > {CPU_GPU_TOL}")
    print(f"new samplers CUDA vs CPU ({time.perf_counter() - t_phase:.1f} s; bs=2, K=4; PC and "
          f"VP Heun {steps} steps, EDM 18; VP energies at t=1e-5, not held: "
          f"{vp_energy_t1e5:.3e}; "
          f"likelihood of 2 poses, {LIKELIHOOD_STEPS} steps, exact divergence, "
          f"{likelihood['seconds']:.3f} s on the card, bits {likelihood['bits']}, launches "
          f"{likelihood['launches']}): max |a-b|/(1+|b|) {diffs} <= {CPU_GPU_TOL}; {card}",
          flush=True)
    return {"diffs": diffs, "likelihood": likelihood}


# ---------------------------------------------------------------------------
# phase 15: the training CLI on a NOCS-format tree
# ---------------------------------------------------------------------------

# CAMERA and Real train scenes of phase 15's tree: the CAMERA:Real 3:1
# resampling gives 384 + 3 x 32 = 480 indices, two full batches of 192 an epoch
CLI_CAMERA_SCENES, CLI_REAL_SCENES = 384, 32
CLI_LIKELIHOOD_STEPS = 50  # phase 15's likelihood flow; 500 is the config default
CLI_EVAL_REPEAT = 5  # phase 15's --eval flow; the config default is 20 (cut to 10 when phase
# 16 came and to 5 when phase 17 came, to keep the script near half its time limit)
# phase 15's --save_video epoch samples this many Heun steps (the config's 500
# would draw 125 frames a sample: ~20 s of splatting and ~16 s of PNG
# writing a mode on the host); its frames are the trajectory's last half.
# Cut from 100 to 50 when phase 21 came, to keep the script near 1000 s.
CLI_VIDEO_STEPS = 50


@contextlib.contextmanager
def metering(*targets):
    """Within the block, each call of ``owner.name`` for (owner, name) in
    ``targets`` (methods of a class, so every instance is metered) is
    recorded under ``name``: host seconds with the device synchronised on
    both sides, and the FPS and ball-query launches inside it."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda

    calls = {name: [] for _, name in targets}
    saved = [(owner, name, vars(owner)[name]) for owner, name in targets]
    for owner, name, fn in saved:
        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            torch.cuda.synchronize()
            f0, b0 = fps_cuda.launches, ball_query_cuda.launches
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls[_name].append({"s": time.perf_counter() - t0, "fps": fps_cuda.launches - f0,
                                 "ball_query": ball_query_cuda.launches - b0})
            return out

        setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def batch_waits():
    """Within the block, the seconds each ``DataLoader`` iterator's consumer
    waits for its next batch."""
    from genpose_tpu_torch.data.loader import DataLoader

    waits, orig = [], DataLoader.__iter__

    def timed_iter(self):
        it = orig(self)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t0)
                yield item
        finally:
            it.close()

    DataLoader.__iter__ = timed_iter
    try:
        yield waits
    finally:
        DataLoader.__iter__ = orig


def run_cli(argv, out_dir):
    """``trainer.main(argv)`` with the launch counters set to 0 before and
    read after, and the PoseAgent methods that launch the kernels metered."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners import trainer
    from genpose_tpu_torch.training.agent import PoseAgent

    methods = ("train_step", "ema_loss", "train_step_energy", "sample", "get_energy",
               "likelihood")
    with metering(*((PoseAgent, m) for m in methods)) as calls, batch_waits() as waits:
        fps_cuda.launches = ball_query_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.main(argv, out_dir=out_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    # every launch of the run happened inside a metered call, 3 + 3 in each
    # (the energy step takes the candidates' geometry: 0 + 0)
    for name, cs in calls.items():
        for c in cs:
            want = (0, 0) if name == "train_step_energy" else (3, 3)
            if (c["fps"], c["ball_query"]) != want:
                raise AssertionError(f"{argv[:2]}: a {name} call launched {c}, expected {want}")
    inside = {k: sum(c[k] for cs in calls.values() for c in cs) for k in launches}
    if inside != launches or not launches["fps"]:
        raise AssertionError(f"{argv[:2]}: launches {launches}, inside metered calls {inside}")
    return {"calls": {k: v for k, v in calls.items() if v}, "waits": waits, "wall_s": wall,
            "launches": launches}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def paeth_png(rgb: np.ndarray) -> bytes:
    """An RGB image as a PNG whose rows all use the Paeth filter, as encoders
    other than cv2's may write them (``utils/png.py`` decodes Paeth byte by
    byte in Python)."""
    import struct
    import zlib

    from genpose_tpu_torch.utils import png

    h = rgb.shape[0]
    rows = rgb.reshape(h, -1).astype(np.int16)
    a, b, c = (np.zeros_like(rows) for _ in range(3))
    a[:, 3:], b[1:], c[1:, 3:] = rows[:, :-3], rows[:-1], rows[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), ((rows - pred) % 256).astype(np.uint8)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", rgb.shape[1], h, 8, 2, 0, 0, 0)
    data = (png._SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))
    if not np.array_equal(png.decode(data), rgb):
        raise AssertionError("the Paeth-filtered PNG does not decode to its image")
    return data


def sample_host_split(tree: str, n: int = 24):
    """One training sample's host time (``NOCSDataset.fetch`` at the
    released recipe's defaults, one thread), split by the functions it
    calls: the three PNG decodes, the DZI box, the three crops,
    ``defor_2D`` and back-projection + sampling; medians over ``n`` samples.
    Also the decode of one colour image re-encoded with Paeth rows."""
    from genpose_tpu_torch.data import nocs
    from genpose_tpu_torch.utils import png

    parts, per = {}, []
    names = {"load_depth": "decode depth", "aug_bbox_DZI": "DZI box",
             "crop_resize_by_warp_affine": "3 crops", "defor_2D": "defor_2D",
             "backproject_and_sample": "back-projection + sampling"}
    saved = {k: getattr(nocs, k) for k in list(names) + ["png"]}

    def timed(label, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            parts[label] = parts.get(label, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    class _Png:  # png.imread, timed by the file it reads
        @staticmethod
        def imread(path, unchanged=False):
            label = "decode color" if path.endswith("_color.png") else "decode mask"
            return timed(label, png.imread)(path, unchanged)

    for k, label in names.items():
        setattr(nocs, k, timed(label, saved[k]))
    nocs.png = _Png
    try:
        ds = nocs.NOCSDataset(tree)
        for i in range(min(n, len(ds))):
            parts.clear()
            t0 = time.perf_counter()
            ds.fetch(i, 1)
            total = time.perf_counter() - t0
            per.append({**parts, "other": total - sum(parts.values()), "total": total})
    finally:
        for k, v in saved.items():
            setattr(nocs, k, v)
    split = {k: float(np.median([p.get(k, 0.0) for p in per])) * 1e3 for k in per[0]}
    color = png.imread(str(Path(tree) / (ds.img_list[0] + "_color.png")))[:, :, ::-1]
    data = paeth_png(np.ascontiguousarray(color))
    t0 = time.perf_counter()
    png.decode(data)
    split["decode color if Paeth-filtered"] = (time.perf_counter() - t0) * 1e3
    return split


def loader_modes(tree: str, card: str):
    """One train epoch of each loader mode at the config's defaults (8
    workers, bs=192, N=1024): samples/s (the process pool's fork
    included) and bit-identical batches.  Returns the rates, the batches an
    epoch and the thread mode's first batch."""
    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.data.loader import get_data_loaders_from_cfg

    epochs, rates = {}, {}
    for mode in ("thread", "process"):
        cfg = get_config(["--data_path", tree, "--loader_mode", mode])
        loader = get_data_loaders_from_cfg(cfg, ["train"])["train_loader"]
        t0 = time.perf_counter()
        epochs[mode] = list(loader)
        secs = time.perf_counter() - t0
        loader.close()
        n = sum(len(b["path"]) for b in epochs[mode])
        rates[mode] = {"samples": n, "seconds": secs, "samples_per_s": n / secs,
                       "workers": cfg.num_workers, "batch_size": cfg.batch_size,
                       "points": cfg.num_points}
    a, b = epochs["thread"], epochs["process"]
    if len(a) != len(b) or len(a) < 2 or any(len(x["path"]) != B_TRAIN for x in a):
        raise AssertionError(f"loader epochs of {len(a)} / {len(b)} batches, expected >= 2 of "
                             f"{B_TRAIN}")
    for x, y in zip(a, b):
        for k in x:
            same = x[k] == y[k] if k == "path" else np.array_equal(x[k], y[k])
            if not same or (k != "path" and x[k].dtype != y[k].dtype):
                raise AssertionError(f"thread and process loaders differ at {k!r}")
    r = rates["thread"]
    print(f"loader, one train epoch (CAMERA+Real resampled, bs={r['batch_size']}, "
          f"N={r['points']}, {r['workers']} workers; the process pool forked after CUDA init): "
          + "; ".join(f"{m} {r['samples']} samples in {r['seconds']:.3f} s = "
                      f"{r['samples_per_s']:.2f} samples/s" for m, r in rates.items())
          + f"; batches bit-identical; {card}", flush=True)
    return rates, len(a), a[0]


def training_cli_path(dev, card, in_memory_step_s: float):
    """Phase 15: ``runners/trainer.py::main`` as a user calls it, on a
    synthetic NOCS-format tree of CLI_CAMERA_SCENES + CLI_REAL_SCENES train
    scenes at 640x480 (the scene count is the only cut), at the released
    recipe's full width: score training, its resume, energy with ranking,
    then the eval, results, prediction and likelihood flows on Real/test."""
    import pickle
    import shutil

    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.data.process import process_batch
    from genpose_tpu_torch.data.synthetic import make_synthetic_nocs_dir
    from genpose_tpu_torch.runners import trainer
    from genpose_tpu_torch.training.checkpoints import load_clock

    root = OUT_DIR / "cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tree = make_synthetic_nocs_dir(str(root / "nocs"), n_camera_scenes=CLI_CAMERA_SCENES,
                                   n_real_scenes=CLI_REAL_SCENES, seed=0)
    tree_s = time.perf_counter() - t0
    out = str(root / "results")
    result = {"tree": tree, "tree_s": tree_s, "scenes": {"CAMERA/train": CLI_CAMERA_SCENES,
                                           "Real/train": CLI_REAL_SCENES}}

    rates, per_epoch, first = loader_modes(tree, card)
    defaults = get_config([])
    repeat = defaults.repeat_num
    result["loader"] = rates
    split = sample_host_split(tree)
    result["sample_host_ms"] = split
    print("one training sample's host time (ms, median of 24, one thread): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; {card}", flush=True)

    # the kernels against their plain versions on a loader batch's clouds
    pts = process_batch(first, "rot_matrix", device=dev)["zero_mean_pts"]
    clouds = pts.cpu().numpy()
    unique = [len(np.unique(c, axis=0)) for c in clouds]
    dup = sum(u < c.shape[0] for u, c in zip(unique, clouds))
    if not dup:
        raise AssertionError("no loader cloud holds a duplicate point: no ties were met")
    held = hold_path_geometry(pts, "loader batch")
    result["loader_clouds"] = {"with_duplicates": dup, "clouds": len(clouds),
                               "min_unique_points": int(min(unique))}
    print(f"FPS and ball query equal their plain versions on a loader batch ({held}; "
          f"{dup} of {len(clouds)} clouds hold exact duplicate points, the fewest distinct "
          f"points in a cloud {min(unique)})", flush=True)

    ckpt_dir = Path(out) / "ckpts" / "cli_score"
    # one process: the flows metered here run in this one (0, every card,
    # would spawn a worker per card on a machine with several)
    common = ["--data_path", tree, "--seed", "0", "--num_devices", "1"]
    # the two-epoch run and the energy run take the process pool, which keeps
    # phase 15 short (an eval epoch's first train batch costs ~2 batches of
    # fetching); the resumed epochs measure both modes, the default first
    score = run_cli(["--agent_type", "score", "--n_epochs", "2", "--eval_freq", "1",
                     "--loader_mode", "process", "--log_dir", "cli_score"] + common, out)
    steps = score["calls"]["train_step"]
    # 2 epochs; an eval epoch after each samples a train and a val batch
    if len(steps) != 2 * per_epoch or len(score["calls"]["sample"]) != 4:
        raise AssertionError(f"score run: {len(steps)} steps, "
                             f"{len(score['calls']['sample'])} eval samplings")
    saved_clock = load_clock(str(ckpt_dir))
    losses = [r["value"] for r in _jsonl(Path(out) / "logs" / "cli_score" / "metrics.jsonl")]
    if (saved_clock != {"epoch": 3, "minibatch": 0, "step": 2 * per_epoch}
            or not np.all(np.isfinite(losses))):
        raise AssertionError(f"score run: clock {saved_clock}, logged values {losses}")
    result["score"] = {"steps": len(steps), "train_step_s": [c["s"] for c in steps],
                       "in_memory_s_per_step": in_memory_step_s, "wall_s": score["wall_s"],
                       "waits_s": score["waits"], "launches": score["launches"],
                       "clock": saved_clock}
    print(f"training CLI score (bs={B_TRAIN}, N={N_POINTS}, repeat {repeat}, Adam, EMA 0.999, "
          f"DZI + defor_2D + point augmentation, process loader; 2 epochs of {per_epoch} steps "
          f"+ an eval epoch each): {score['wall_s']:.3f} s; train_step "
          f"{[round(c['s'], 4) for c in steps]} s (phase 7 in memory {in_memory_step_s:.4f} s); "
          f"clock {saved_clock}; launches {score['launches']}; {card}", flush=True)

    def resumed_epoch(mode: str):
        """One more epoch by ``--use_pretrain`` with the ``mode`` loader,
        profiled on the device: the clock must advance one epoch."""
        before, holder = load_clock(str(ckpt_dir)), {}
        prof = device_profile(lambda: holder.update(run=run_cli(
            ["--agent_type", "score", "--n_epochs", str(before["epoch"]), "--eval_freq", "100",
             "--use_pretrain", "true", "--loader_mode", mode, "--log_dir", "cli_score"] + common,
            out)), f"a resumed loader-fed epoch ({mode} loader)", cpu=False)
        run, clock = holder["run"], load_clock(str(ckpt_dir))
        want = dict(before, epoch=before["epoch"] + 1, step=before["step"] + per_epoch)
        if clock != want or not (ckpt_dir / f"ckpt_epoch{clock['epoch']}").exists():
            raise AssertionError(f"resume from {before}: clock {clock}, expected {want}")
        rows = _jsonl(Path(out) / "logs" / "cli_score" / "metrics.jsonl")
        epoch_s = [r["value"] for r in rows if r["tag"] == "epoch_time_s"][-1]
        busy = None if prof["device_ms"] is None else prof["device_ms"] / 1e3 / epoch_s
        waits = run["waits"]
        out_row = {"loader_mode": mode, "clock_before": before, "clock": clock,
                   "epoch_s": epoch_s, "wall_s": run["wall_s"],
                   "train_step_s": [c["s"] for c in run["calls"]["train_step"]],
                   "waits_s": waits, "wait_share": sum(waits) / epoch_s,
                   "s_per_step_fed": epoch_s / per_epoch, "device_ms": prof["device_ms"],
                   "busy_share": busy, "launches": run["launches"]}
        print(f"training CLI resumed epoch, {mode} loader: {epoch_s:.3f} s for {per_epoch} "
              f"steps = {epoch_s / per_epoch:.3f} s per step fed from the loader (train_step "
              f"{[round(x, 4) for x in out_row['train_step_s']]} s; phase 7 in memory "
              f"{in_memory_step_s:.4f} s), waiting for batches {sum(waits):.3f} s = "
              f"{sum(waits) / epoch_s:.4f} of it, device busy "
              f"{'not measured' if busy is None else f'{busy:.4f}'} of it; clock {before} -> "
              f"{clock}; launches {run['launches']}; {card}", flush=True)
        return out_row

    result["score"]["resumed"] = [resumed_epoch("thread"), resumed_epoch("process")]
    last_ckpt = ckpt_dir / f"ckpt_epoch{load_clock(str(ckpt_dir))['epoch']}"

    energy = run_cli(["--agent_type", "energy_with_ranking", "--pretrained_score_model_path",
                      str(last_ckpt), "--sampler_mode", "ode_adaptive", "--n_epochs", "1",
                      "--loader_mode", "process", "--log_dir", "cli_energy"] + common, out)
    iters = list(zip(energy["calls"]["sample"], energy["calls"]["train_step_energy"]))
    if (len(iters) != per_epoch
            or not (Path(out) / "ckpts" / "cli_energy" / "ckpt_epoch2").exists()):
        raise AssertionError(f"energy_with_ranking: {len(iters)} iterations")
    rows = _jsonl(Path(out) / "logs" / "cli_energy" / "metrics.jsonl")
    if not all(np.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"energy_with_ranking logged {rows}")
    result["energy"] = {"iterations": len(iters),
                        "iteration_s": [a["s"] + b["s"] for a, b in iters],
                        "wall_s": energy["wall_s"], "waits_s": energy["waits"],
                        "launches": energy["launches"]}
    print(f"training CLI energy_with_ranking (K=5 candidates by ode_adaptive, 1 epoch, process "
          f"loader): iterations {[round(x, 4) for x in result['energy']['iteration_s']]} s, "
          f"waits {[round(x, 3) for x in energy['waits']]} s, wall {energy['wall_s']:.3f} s; "
          f"launches {energy['launches']} (FPS 3 + ball query 3 an iteration); {card}",
          flush=True)

    # the inference flows on Real/test (one batch of CLI_REAL_SCENES objects)
    test = ["--max_eval_num", "0"] + common
    flows = {"eval": run_cli(["--agent_type", "score", "--eval", "true", "--repeat_num",
                              str(CLI_EVAL_REPEAT), "--log_dir", "cli_score"] + test, out)}
    res_dir = (Path(out) / "inference_results" / "cli_score"
               / f"{defaults.test_source}_{defaults.sampler_mode[0]}_{defaults.sampling_steps}")
    results_pkl = res_dir / "results.pkl"
    before = results_pkl.read_bytes()
    t0 = time.perf_counter()
    trainer.main(["--results_path", str(results_pkl)] + common, out_dir=out)
    flows["results_path_s"] = time.perf_counter() - t0
    if results_pkl.read_bytes() != before or not (res_dir / "average_results.pkl").exists():
        raise AssertionError("--results_path: the input changed or average_results.pkl is missing")
    printed = io.StringIO()  # the drawing's line, when the SO(3) images are skipped
    with contextlib.redirect_stdout(printed):
        flows["pred"] = run_cli(["--agent_type", "energy_with_ranking",
                                 "--pretrained_score_model_path", str(last_ckpt), "--pred", "true",
                                 "--log_dir", "cli_energy"] + test, out)
    sys.stdout.write(printed.getvalue())
    flows["likelihood"] = run_cli(["--agent_type", "score", "--likelihood", "true",
                                   "--sampling_steps", str(CLI_LIKELIHOOD_STEPS), "--log_dir",
                                   "cli_score"] + test, out)
    with open(results_pkl, "rb") as f:
        res = pickle.load(f)
    with open(Path(out) / "predictions" / "cli_energy" / "prediction_results.pkl", "rb") as f:
        pred = pickle.load(f)
    with open(Path(out) / "inference_results" / "cli_score"
              / f"{defaults.test_source}_likelihood" / "likelihood.json") as f:
        lik = json.load(f)
    n_obj = res["gt_pose"].shape[0]
    checks = {
        "metrics.json": (res_dir / "metrics.json").exists(),
        "results.pkl": res["pred_pose"].shape == (n_obj, CLI_EVAL_REPEAT, 9)
        and np.isfinite(res["pred_pose"]).all() and n_obj == CLI_REAL_SCENES,
        "eval samplings": len(flows["eval"]["calls"]["sample"]) == CLI_EVAL_REPEAT,
        "prediction_results.pkl": len(pred) == 1
        and pred[0]["pred_pose"].shape == (n_obj, repeat, 7)
        and np.isfinite(pred[0]["energy"]).all() and np.isfinite(pred[0]["average_pred_pose"]).all(),
        "likelihood.json": lik["n"] == n_obj and np.isfinite(lik["mean_bits"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"inference flows: {checks}")
    result["flows"] = {
        "eval": {"wall_s": flows["eval"]["wall_s"], "launches": flows["eval"]["launches"],
                 "sample_s": [c["s"] for c in flows["eval"]["calls"]["sample"]]},
        "results_path_s": flows["results_path_s"],
        "pred": {"wall_s": flows["pred"]["wall_s"], "launches": flows["pred"]["launches"]},
        "likelihood": {"wall_s": flows["likelihood"]["wall_s"], "steps": CLI_LIKELIHOOD_STEPS,
                       "launches": flows["likelihood"]["launches"],
                       "mean_bits": lik["mean_bits"]}}
    pred_dir = Path(out) / "predictions" / "cli_energy"
    so3 = sorted(p.name for p in pred_dir.glob("so3_distribution_*.png"))
    skipped = [line for line in printed.getvalue().splitlines()
               if line.startswith("visualization skipped")]
    if len(so3) != min(n_obj, 8) and not skipped:
        raise AssertionError(f"--pred wrote {so3} and printed no skipped drawing")
    result["flows"]["pred"].update(so3_images=len(so3), drawing=skipped or "drawn")
    print(f"training CLI flows on Real/test ({n_obj} objects, one batch): --eval (repeat "
          f"{CLI_EVAL_REPEAT}, Heun-{defaults.sampling_steps}) {flows['eval']['wall_s']:.3f} s, launches {flows['eval']['launches']}; "
          f"--results_path {flows['results_path_s']:.3f} s; --pred (K={repeat}, energy ranking) "
          f"{flows['pred']['wall_s']:.3f} s, launches {flows['pred']['launches']}, SO(3) images "
          f"{len(so3)} ({skipped[0] if skipped else 'drawn'}); --likelihood "
          f"({CLI_LIKELIHOOD_STEPS} steps) {flows['likelihood']['wall_s']:.3f} s, launches "
          f"{flows['likelihood']['launches']}; every artifact written; {card}", flush=True)
    result["video"] = video_epoch(out, common, str(ckpt_dir), card)
    return result


def video_epoch(out: str, common, ckpt_dir: str, card: str):
    """Phase 15, last: one more score epoch by ``--use_pretrain`` with
    ``--save_video true``: its eval epoch samples the first train and val
    batch with their trajectories (Heun, CLI_VIDEO_STEPS steps) and writes
    each one's result grid and the diffusion frames of its first (at most
    16) samples as PNGs.  Prints the frames written and the seconds the drawing
    took (host only)."""
    from genpose_tpu_torch.runners import trainer
    from genpose_tpu_torch.training.checkpoints import load_clock

    epoch = load_clock(ckpt_dir)["epoch"] + 1  # the eval epoch's number, after the epoch
    drawing, real = [], trainer._visualize_eval

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        real(*args, **kwargs)
        drawing.append(time.perf_counter() - t0)

    trainer._visualize_eval = timed
    try:
        run = run_cli(["--agent_type", "score", "--n_epochs", str(epoch - 1), "--eval_freq", "1",
                       "--use_pretrain", "true", "--save_video", "true", "--sampling_steps",
                       str(CLI_VIDEO_STEPS), "--loader_mode", "process", "--log_dir",
                       "cli_score"] + common, out)
    finally:
        trainer._visualize_eval = real
    frames = {}
    for mode in ("train", "val"):
        d = Path(out) / "logs" / "cli_score" / f"video_epoch{epoch}_{mode}"
        examples = sorted(d.glob("example_*"))
        counts = {len(list(e.glob("frame_*.png"))) for e in examples}
        # Heun's trajectory holds CLI_VIDEO_STEPS states, the frames its last half
        if (not (d / "res_grid.png").exists() or not 1 <= len(examples) <= 16
                or counts != {CLI_VIDEO_STEPS // 2}):
            raise AssertionError(f"--save_video {mode}: {len(examples)} examples, frame counts "
                                 f"{counts}, res_grid.png {(d / 'res_grid.png').exists()}")
        frames[mode] = {"samples": len(examples), "frames": len(examples) * CLI_VIDEO_STEPS // 2}
    samples = [c["s"] for c in run["calls"]["sample"]]
    print(f"training CLI --save_video epoch (Heun-{CLI_VIDEO_STEPS} with its trajectory in "
          f"the eval epoch): PNG frames written {frames} ({CLI_VIDEO_STEPS // 2} a sample, at "
          f"most 16 samples a mode) + res_grid.png each; the drawing took "
          f"{[round(x, 3) for x in drawing]} s (host), the two samplings "
          f"{[round(x, 4) for x in samples]} s; wall {run['wall_s']:.3f} s; launches "
          f"{run['launches']}; {card}", flush=True)
    return {"frames": frames, "drawing_s": drawing, "sample_s": samples,
            "wall_s": run["wall_s"], "launches": run["launches"]}


# phase 16: every encoder, PointNet++ stage config and pose mode of the JAX
# config beside the released model's (light PointNet++, rot_matrix), each
# at the serving phase's full width
NEW_CONFIGS = {
    "pointnet": dict(pts_encoder="pointnet"),
    "pointnet_and_pointnet2": dict(pts_encoder="pointnet_and_pointnet2"),
    "full": dict(pointnet2_params="full"),
    "lighter": dict(pointnet2_params="lighter"),
    "dense": dict(pointnet2_params="dense"),
    "euler_xyz_sx_cx": dict(pose_mode="euler_xyz_sx_cx", regression_head="R_and_T"),
}
NEW_TRAIN_CONFIGS, NEW_TRAIN_STEPS = ("pointnet_and_pointnet2", "full"), 3


def new_config_kernels(dev, card):
    """Phase 16 (1): FPS and ball query against their plain versions, bit
    for bit, at every stage of the ``full``, ``lighter`` and ``dense`` chains
    (``Pointnet2MSG``'s chain is ``full``'s first four stages) at B=64,
    N=1024, on object clouds and on clouds tiled from 200 points (exact
    duplicates); every shape that phase 3's ``light`` chain does not run is
    timed as phase 3 times its shapes."""
    from genpose_tpu_torch.models.pointnet2 import CLS_MSG_CONFIGS, MSG_CFG
    from genpose_tpu_torch.ops import pointcloud as pc
    from genpose_tpu_torch.ops.ball_query_cuda import ball_query_cuda
    from genpose_tpu_torch.ops.fps_cuda import fps_cuda
    from genpose_tpu_torch.tools.bench_fused_geometry import cuda_ms

    full = CLS_MSG_CONFIGS["full"]
    if any(MSG_CFG[k] != full[k][:4] for k in ("NPOINTS", "RADIUS", "NSAMPLE")):
        raise AssertionError("Pointnet2MSG's stages are no longer full's first four")
    gen = torch.Generator(device=dev).manual_seed(16)
    clouds = object_clouds(gen, B, N_POINTS, dev)
    clouds = clouds - clouds.mean(dim=1, keepdim=True)
    tiled = object_clouds(gen, B, 200, dev).repeat(1, 6, 1)[:, :N_POINTS].contiguous()
    # the shapes phase 3 times; a new shape's row, by shape, lists its configs
    seen = {(n, m) for n, m in FPS_SHAPES}
    seen |= {(n, m, tuple(r), BQ_NSAMPLE) for (n, m), r in zip(FPS_SHAPES, BQ_RADII)}
    rows, checked = {}, 0
    for name in ("full", "lighter", "dense"):
        cfg = CLS_MSG_CONFIGS[name]
        for kind, xyz in (("object", clouds), ("tiled", tiled)):
            for npoint, radii, nsamples in zip(cfg["NPOINTS"], cfg["RADIUS"], cfg["NSAMPLE"]):
                if npoint is None:  # GroupAll: no kernel
                    break
                radii, nsamples, n = tuple(radii), tuple(nsamples), xyz.shape[1]
                what = f"{name} {kind} B{B} N{n} M{npoint} r{radii} S{nsamples}"
                idx = fps_cuda(xyz, npoint)
                want = pc.farthest_point_sample_ref(xyz, npoint)
                torch.cuda.synchronize()
                if not torch.equal(idx, want):
                    raise AssertionError(f"FPS kernel != plain: {what}")
                centers = pc.gather_points(xyz, want)
                got = ball_query_cuda(radii, nsamples, xyz, centers)
                want_bq = pc.ball_query_msg_ref(radii, nsamples, xyz, centers)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want_bq)):
                    raise AssertionError(f"ball-query kernel != plain: {what}")
                checked += 2
                fps_key, bq_key = (n, npoint), (n, npoint, radii, nsamples)
                if kind == "object" and fps_key not in seen and fps_key not in rows:
                    ms = cuda_ms(lambda: fps_cuda(xyz, npoint), 50)
                    dev_ms = device_ms(lambda: fps_cuda(xyz, npoint), 20, "fps_kernel")
                    plain = cuda_ms(lambda: pc.farthest_point_sample_ref(xyz, npoint), 3)
                    rows[fps_key] = row(f"B{B} N{n} npoint{npoint}", ms, plain,
                                        B * n * 12 + B * npoint * 4, B * (npoint - 1) * n * 10,
                                        device_ms=dev_ms, us_per_round=per_round(dev_ms, npoint),
                                        configs=[])
                if kind == "object" and bq_key not in seen and bq_key not in rows:
                    ms = cuda_ms(lambda: ball_query_cuda(radii, nsamples, xyz, centers), 50)
                    dev_ms = device_ms(lambda: ball_query_cuda(radii, nsamples, xyz, centers),
                                       20, "ball_query_kernel")
                    plain = cuda_ms(lambda: pc.ball_query_msg_ref(radii, nsamples, xyz, centers),
                                    5)
                    later, per_radius, hits = examined_pairs(xyz, centers, radii, nsamples,
                                                             want_bq)
                    io = B * n * 12 + B * npoint * 12
                    rows[bq_key] = row(f"B{B} N{n} M{npoint} r{radii} S{nsamples}", ms, plain,
                                       io + B * npoint * sum(nsamples) * 4,
                                       later * 8 + sum(per_radius), device_ms=dev_ms,
                                       mean_hits=hits, configs=[])
                for key in (fps_key, bq_key):
                    if kind == "object" and key in rows and name not in rows[key]["configs"]:
                        rows[key]["configs"].append(name)
                xyz = centers
    fps_rows = [r for k, r in rows.items() if len(k) == 2]
    bq_rows = [r for k, r in rows.items() if len(k) == 4]
    print(f"phase 16 kernels: FPS and ball query equal their plain versions at every stage of "
          f"the full, lighter and dense chains (Pointnet2MSG's included), on object and tiled "
          f"clouds ({checked} launches compared); new shapes timed: "
          + "; ".join(f"FPS {r['shape']} {_ms(r['device_ms'])} (bound {r['bound_ms']:.4f})"
                      for r in fps_rows)
          + "; " + "; ".join(f"ball query {r['shape']} {_ms(r['device_ms'])} (bound "
                             f"{r['bound_ms']:.4f}, {r['configs']})" for r in bq_rows)
          + f"; {card}", flush=True)
    return fps_rows, bq_rows


def msg_encoder_on_card(dev, card):
    """Phase 16 (2): the SA + FP encoder ``Pointnet2MSG`` once on the card
    (4 FPS + 4 ball-query launches) against the same weights on the CPU,
    on grid clouds (phase 5) at N=1024: per-point features and logit within
    CPU_GPU_TOL scaled; one forward timed at B=64."""
    import copy

    from genpose_tpu_torch.models.pointnet2 import Pointnet2MSG
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.tools.bench_fused_geometry import cuda_ms
    from genpose_tpu_torch.utils.weights import init_params_, perturb_

    net = perturb_(init_params_(Pointnet2MSG(), seed=16), seed=17).eval()
    cpu_net = copy.deepcopy(net)
    net = net.to(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    pts = object_clouds(gen, 4, N_POINTS, dev, grid=2.0 ** -10)
    torch.cuda.synchronize()
    fps_cuda.launches = ball_query_cuda.launches = 0
    with torch.no_grad():
        feat, logit = net(pts)
        torch.cuda.synchronize()
        launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
        want_feat, want_logit = cpu_net(pts.cpu())
        big = object_clouds(gen, B, N_POINTS, dev)
        ms = cuda_ms(lambda: net(big), 5)
    if launches != {"fps": 4, "ball_query": 4}:
        raise AssertionError(f"Pointnet2MSG launches {launches}, expected 4 and 4")
    worst = max(_scaled_diff(feat.cpu().numpy(), want_feat.numpy()),
                _scaled_diff(logit.cpu().numpy(), want_logit.numpy()))
    if worst > CPU_GPU_TOL or feat.shape != (4, N_POINTS, 64) or logit.shape != (4, N_POINTS, 1):
        raise AssertionError(f"Pointnet2MSG CUDA vs CPU {worst} (shapes {feat.shape}, "
                             f"{logit.shape})")
    print(f"Pointnet2MSG on the card (N={N_POINTS}): launches {launches}; CUDA vs CPU max "
          f"|a-b|/(1+|b|) = {worst:.3e} <= {CPU_GPU_TOL}; one forward at B={B} {ms:.3f} ms "
          f"(CUDA events); {card}", flush=True)
    return {"launches": launches, "cpu_gpu": worst, "forward_ms_b64": ms}


def new_config_serving(dev, card, pts: np.ndarray):
    """Phase 16 (3): per new configuration, at full width, an eager Heun-500
    request after a warm-up, then the same request frozen (bit for bit, 2
    frozen dispatches a chunk) and profiled; then the phase-5 check on a
    small grid request, CUDA against the CPU."""
    from genpose_tpu_torch.training import frozen

    result = {}
    for name, kw in NEW_CONFIGS.items():
        t0 = time.perf_counter()
        pipe = make_pipeline(dev, sampler_mode=("ode",), **kw).warmup()
        chunks = -(-pts.shape[0] // pipe.bs)
        eager, eager_s, launches = drive(pipe, pts, f"{name} eager")
        pipe.freeze().warmup()
        frozen.dispatches = 0
        got, frozen_s, frozen_launches = drive(pipe, pts, f"{name} frozen")
        if frozen.dispatches != 2 * chunks:
            raise AssertionError(f"{name} frozen: {frozen.dispatches} frozen dispatches, "
                                 f"expected {2 * chunks}")
        if not all(np.array_equal(got[k], eager[k]) for k in eager):
            raise AssertionError(f"{name}: the frozen request differs from eager")
        prof = device_profile(
            lambda: pipe.predict(pts, generator=torch.Generator(device=dev).manual_seed(1)),
            f"{name}, frozen request", cpu=False)
        del pipe
        torch.cuda.empty_cache()
        worst = cpu_gpu_agreement(dev, f" {name}", **kw)
        torch.cuda.empty_cache()
        result[name] = {"eager_s": eager_s, "frozen_s": frozen_s,
                        "eager_poses_per_s": B / eager_s, "frozen_poses_per_s": B / frozen_s,
                        "frozen_profile": prof, "launches": launches,
                        "frozen_launches": frozen_launches, "cpu_gpu": worst,
                        "phase_s": time.perf_counter() - t0}
        print(f"phase 16 serving {name} {kw} (bs={B}, K={K}, N={N_POINTS}, Heun-{HEUN_STEPS}): "
              f"eager {eager_s:.4f} s = {B / eager_s:.2f} poses/s, frozen {frozen_s:.4f} s = "
              f"{B / frozen_s:.2f} poses/s, frozen busy {prof['busy']} ({prof['device_ms']} "
              f"device ms, {prof['kernels']} kernels); launches per request {launches}; frozen "
              f"= eager bit for bit; CUDA vs CPU {worst:.3e}; {card}", flush=True)
    return result


def new_config_training(dev, card, light_step_s: float):
    """Phase 16 (4): NEW_TRAIN_STEPS in-memory score steps at the released
    recipe (bs=192, N=1024) per configuration of NEW_TRAIN_CONFIGS: seconds
    per step (median after the first), peak memory, launches per step,
    finite losses; beside phase 7's ``light`` step."""
    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.data.process import process_batch
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.utils.weights import perturb_

    rng = np.random.default_rng(16)
    result = {}
    for name in NEW_TRAIN_CONFIGS:
        cfg = Config(seed=0, **NEW_CONFIGS[name])
        agent = PoseAgent(cfg, "score", device=dev)
        perturb_(agent.model, seed=16)
        raws = _raw_batches(rng, NEW_TRAIN_STEPS, cfg.batch_size, cfg.num_points)
        gen = torch.Generator(device=dev).manual_seed(16)
        meter = StepMeter(agent, "train_step")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for raw in raws:
            batch = process_batch(raw, cfg.pose_mode, gen, cfg.pts_aug, device=dev)
            losses.append(float(agent.train_step(batch, gen)["gf"]))
        meter.close()
        peak = torch.cuda.max_memory_allocated()
        per = geometry_stages(cfg)
        for n, call in enumerate(meter.calls):
            if (call["fps"], call["ball_query"]) != (per, per) or not np.isfinite(losses[n]):
                raise AssertionError(f"{name} score step {n}: {call}, loss {losses[n]}")
        s_step = float(np.median([c["s"] for c in meter.calls[1:]]))
        result[name] = {"s_per_step": s_step, "samples_per_s": cfg.batch_size / s_step,
                        "first_step_s": meter.calls[0]["s"], "peak_mem_gb": peak / 1e9,
                        "losses": losses, "launches_per_step": per}
        print(f"phase 16 score steps {name} (bs={cfg.batch_size}, N={cfg.num_points}, repeat "
              f"{cfg.repeat_num}, Adam): {s_step:.4f} s per step = {cfg.batch_size / s_step:.1f} "
              f"samples/s (first {meter.calls[0]['s']:.3f} s; phase 7 light {light_step_s:.4f} s)"
              f"; peak memory {peak / 1e9:.3f} GB; losses {[round(x, 4) for x in losses]}; "
              f"FPS {per} + ball query {per} per step; {card}", flush=True)
        del agent
        torch.cuda.empty_cache()
    return result


def new_configurations(dev, card, pts: np.ndarray, light_step_s: float):
    """Phase 16: the kernels at the new configurations' shapes, the SA + FP
    encoder, serving under each new configuration and score steps."""
    t0 = time.perf_counter()
    fps_rows, bq_rows = new_config_kernels(dev, card)
    out = {"fps_rows": fps_rows, "bq_rows": bq_rows, "msg_encoder": msg_encoder_on_card(dev, card)}
    torch.cuda.empty_cache()
    out["serving"] = new_config_serving(dev, card, pts)
    out["training"] = new_config_training(dev, card, light_step_s)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 16 took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: every sampler through the frozen programs
# ---------------------------------------------------------------------------


def _equal_or_fail(label: str, got: dict, want: dict) -> str:
    """Hold frozen results to eager ones bit for bit."""
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{label}: {k} frozen != eager, max |a-b|/(1+|b|) "
                                 f"{_scaled_diff(got[k], want[k])}")
    return "bit for bit"


def frozen_sampler_serving(dev, card, pts: np.ndarray, eager14: dict):
    """Phase 17 (1): a full-width request under PC-500 (VE) and EDM-18, in
    float32 and bfloat16, eagerly and then through ``freeze()`` from the
    same generator seed (one warm-up request before each timed one): bit for
    bit, 2 frozen dispatches and FPS 3 + ball query 3 a request; seconds,
    poses/s, the frozen request's profile, the warm-up and capture seconds
    and the device memory the frozen programs hold, beside phase 14's eager
    seconds."""
    from genpose_tpu_torch.training import frozen

    result = {}
    for name in ("pc", "edm"):
        for dtype in ("float32", "bfloat16"):
            arm = f"{name} {dtype}"
            pipe = make_pipeline(dev, compute_dtype=dtype, **SAMPLER_ARMS[name]).warmup()
            eager, eager_s, _ = drive(pipe, pts, f"{arm} eager")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            with _traced() as captured:
                pipe.freeze().warmup()
            freeze_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            held_mb = (torch.cuda.memory_reserved() - reserved0) / 2 ** 20
            frozen.dispatches = 0
            got, frozen_s, launches = drive(pipe, pts, f"{arm} frozen")
            if frozen.dispatches != 2:
                raise AssertionError(f"frozen {arm}: {frozen.dispatches} frozen dispatches, "
                                     f"expected 2")
            how = _equal_or_fail(f"frozen serving {arm}", got, eager)
            prof = device_profile(
                lambda: pipe.predict(pts, generator=torch.Generator(device=dev).manual_seed(1)),
                f"serving {arm}, frozen request", cpu=False)
            graphs = _graph_stats(captured)
            phase14_s = eager14[name]["seconds"] if dtype == "float32" else None
            result[f"{name}_{dtype}"] = {
                "steps": pipe.cfg.sampling_steps, "eager_s": eager_s, "frozen_s": frozen_s,
                "eager_poses_per_s": B / eager_s, "frozen_poses_per_s": B / frozen_s,
                "phase14_eager_s": phase14_s, "frozen_profile": prof,
                "freeze_and_warmup_s": freeze_s, "graphs": graphs, "held_mb": held_mb,
                "launches": launches, "dispatches": 2, "agreement": how}
            print(f"frozen {name} {dtype} (bs={B}, K={K}, N={N_POINTS}, sde "
                  f"{pipe.cfg.sde_mode}, {pipe.cfg.sampling_steps} steps): eager "
                  f"{eager_s:.4f} s = {B / eager_s:.2f} poses/s (phase 14 eager f32: "
                  f"{'-' if phase14_s is None else f'{phase14_s:.4f} s'}), frozen "
                  f"{frozen_s:.4f} s = {B / frozen_s:.2f} poses/s; frozen busy {prof['busy']}, "
                  f"device ms {prof['device_ms']}, {prof['kernels']} device kernels; freeze + "
                  f"warmup {freeze_s:.3f} s, programs {graphs}; graph pool {held_mb:.1f} MiB "
                  f"(reserved); launches {launches}, frozen dispatches 2; frozen vs eager "
                  f"{how}; {card}", flush=True)
            del pipe
            torch.cuda.empty_cache()
    return result


def frozen_trajectories_and_likelihood(dev, card, pts: np.ndarray):
    """Phase 17 (2): at full width a Heun-500 and a PC-500 request with the
    trajectory (``return_process``), eagerly and frozen from the same seed
    (trajectory and poses bit for bit); then the PF-ODE likelihood of each
    cloud's first hypothesis (LIKELIHOOD_STEPS steps, exact divergence)
    eagerly and on the frozen agent, bit for bit.  FPS 3 + ball query 3 in
    each call."""
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.training import frozen

    x = torch.from_numpy(pts).to(dev)
    center = x.mean(dim=1)
    batch = {"zero_mean_pts": x - center[:, None], "pts_center": center}

    def timed(fn, label):
        torch.cuda.synchronize()
        fps_cuda.launches = ball_query_cuda.launches = frozen.dispatches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
        if launches != {"fps": 3, "ball_query": 3}:
            raise AssertionError(f"{label}: launches {launches}, expected 3 + 3")
        return out, seconds, launches, frozen.dispatches

    result = {}
    for sampler, overrides in (("ode", {}), ("pc", SAMPLER_ARMS["pc"])):
        agent = make_pipeline(dev, **overrides).score_agent

        def request():
            gen = torch.Generator(device=dev).manual_seed(1)
            return agent.sample(batch, gen, repeat_num=K, sampler=sampler, num_steps=HEUN_STEPS,
                                T0=EVAL_T0, return_process=True)

        timed(request, f"{sampler} trajectory warm-up")
        (eproc, epose), eager_s, _, _ = timed(request, f"{sampler} trajectory eager")
        if sampler == "ode":  # the likelihood of each cloud's first hypothesis, eagerly
            poses = epose[:, 0].clone()
            poses[:, -3:] -= center

            def likelihood():
                return agent.likelihood(batch, poses, num_steps=LIKELIHOOD_STEPS)

            (ez, ebits), lik_eager_s, _, _ = timed(likelihood, "likelihood eager")
        agent.freeze()
        t0 = time.perf_counter()
        timed(request, f"{sampler} trajectory capture")
        capture_s = time.perf_counter() - t0
        (fproc, fpose), frozen_s, launches, dispatches = timed(request, f"{sampler} trajectory")
        if eproc.shape != (B, K, HEUN_STEPS, 9) or dispatches != 1:
            raise AssertionError(f"{sampler} trajectory: shape {tuple(eproc.shape)}, frozen "
                                 f"dispatches {dispatches}")
        how = _equal_or_fail(f"{sampler} trajectory", {"trajectory": fproc.cpu().numpy(),
                                                       "poses": fpose.cpu().numpy()},
                             {"trajectory": eproc.cpu().numpy(), "poses": epose.cpu().numpy()})
        result[f"{sampler}_trajectory"] = {"eager_s": eager_s, "frozen_s": frozen_s,
                                           "warmup_and_capture_s": capture_s,
                                           "launches": launches, "agreement": how,
                                           "bytes": eproc.numel() * 4}
        print(f"frozen {sampler} request with its trajectory (bs={B}, K={K}, {HEUN_STEPS} "
              f"steps, [{B}, {K}, {HEUN_STEPS}, 9] = {eproc.numel() * 4 / 2 ** 20:.1f} MiB): "
              f"eager {eager_s:.4f} s, frozen {frozen_s:.4f} s (warm-up + capture "
              f"{capture_s:.3f} s); launches {launches}; trajectory and poses {how}; {card}",
              flush=True)
        if sampler == "ode":
            (fz, fbits), lik_frozen_s, lik_launches, lik_dispatches = timed(
                likelihood, "likelihood frozen")
            if lik_dispatches != 1 or not torch.isfinite(fbits).all():
                raise AssertionError(f"frozen likelihood: dispatches {lik_dispatches}, bits "
                                     f"{fbits}")
            lik_how = _equal_or_fail("likelihood", {"z": fz.cpu().numpy(),
                                                    "bits": fbits.cpu().numpy()},
                                     {"z": ez.cpu().numpy(), "bits": ebits.cpu().numpy()})
            result["likelihood"] = {"poses": B, "steps": LIKELIHOOD_STEPS,
                                    "eager_s": lik_eager_s, "frozen_s": lik_frozen_s,
                                    "launches": lik_launches, "agreement": lik_how,
                                    "mean_bits": float(fbits.mean())}
            print(f"frozen likelihood ({B} poses, {LIKELIHOOD_STEPS} steps, exact divergence, "
                  f"on the frozen copy of the weights): eager {lik_eager_s:.4f} s, frozen "
                  f"{lik_frozen_s:.4f} s; launches {lik_launches}, frozen dispatches 1; "
                  f"{lik_how}; mean {float(fbits.mean()):.3f} bits; {card}", flush=True)
        del agent
        torch.cuda.empty_cache()
    return result


def frozen_sampler_runners(dev, card, nocs: str, seg: str, chunks: int, instances: int):
    """Phase 17 (3): ``evaluation_single`` stages 2-3 on phase 9's tree under
    ``--sampler_mode pc`` (PC-500), eagerly and with both agents frozen as
    ``main`` freezes them: the results bit for bit; then ``main_tracking``
    on phase 10's frames under ``--sde_mode edm --sampler_mode edm`` (EDM-18),
    the eager arm (``freeze`` a no-op) and as a user calls it: pooled poses
    bit for bit, the metrics equal."""
    import pickle

    cfg = eval_config(nocs, str(OUT_DIR / "eval" / "single_pc"), **SAMPLER_ARMS["pc"])
    score, energy = eval_agents(cfg, dev)
    dirs = {arm: str(OUT_DIR / "eval" / "single_pc" / arm) for arm in ("eager", "frozen")}
    secs, launches = {}, {}
    for arm in ("eager", "frozen"):
        if arm == "frozen":
            score.freeze()
            energy.freeze()
        secs[arm], launches[arm], dispatches = eval_stages_2_3(cfg, score, energy, seg, dirs[arm],
                                                               chunks, f"pc {arm}")
        want = {"stage 2": chunks if arm == "frozen" else 0,
                "stage 3": chunks if arm == "frozen" else 0}
        if dispatches != want:
            raise AssertionError(f"evaluation pc {arm}: frozen dispatches {dispatches}, "
                                 f"expected {want}")

    def load(arm, name):
        with open(Path(dirs[arm]) / name, "rb") as f:
            return pickle.load(f)

    for name, keys in (("results_wo_energy.pkl", ("multi_hypothesis_pred_RTs",)),
                       ("results_with_energy.pkl", ("multi_hypothesis_pred_RTs", "energy"))):
        a, b = load("frozen", name), load("eager", name)
        _equal_or_fail(f"evaluation pc {name}", {f"{p}:{k}": a[p]["result"][k] for p in a
                                                 for k in keys},
                       {f"{p}:{k}": b[p]["result"][k] for p in b for k in keys})
    del score, energy
    torch.cuda.empty_cache()
    evaluation = {"seconds": secs, "launches": launches,
                  "stage2_poses_per_s": {a: instances / secs[a]["stage 2"] for a in secs},
                  "agreement": "bit for bit"}
    print(f"evaluation_single under --sampler_mode pc ({instances} instances in {chunks} chunks "
          f"padded to {cfg.batch_size}; K={K}, PC-{cfg.sampling_steps}): stage 2 eager "
          f"{secs['eager']['stage 2']:.4f} s = "
          f"{evaluation['stage2_poses_per_s']['eager']:.2f} poses/s, frozen "
          f"{secs['frozen']['stage 2']:.4f} s = {evaluation['stage2_poses_per_s']['frozen']:.2f} "
          f"poses/s (capture included); stage 3 eager {secs['eager']['stage 3']:.4f} s, frozen "
          f"{secs['frozen']['stage 3']:.4f} s; launches {launches['frozen']}; frozen vs eager "
          f"bit for bit; {card}", flush=True)

    edm = SAMPLER_ARMS["edm"]
    agents = eval_agents(eval_config(nocs, "", **edm), dev)
    eager, eager_poses, eager_metrics = tracking_path(dev, card, nocs, agents, **edm)
    got, poses, metrics = tracking_path(dev, card, nocs, agents, frozen_arm=True, **edm)
    how = _equal_or_fail("tracking edm pooled poses", dict(enumerate(poses)),
                         dict(enumerate(eager_poses)))
    for name, m in eager_metrics.items():
        if (metrics[name]["5d5cm_acc"] != m["5d5cm_acc"]
                or not np.array_equal(metrics[name]["mean_error"], m["mean_error"])):
            raise AssertionError(f"tracking edm metrics of {name}: frozen {metrics[name]}, "
                                 f"eager {m}")
    print(f"main_tracking under --sde_mode edm --sampler_mode edm (EDM-{edm['sampling_steps']}): "
          f"eager {eager['frames_per_s']:.3f} frames/s, frozen {got['frames_per_s']:.3f} "
          f"frames/s (capture included); pooled poses {how}, metrics equal; {card}", flush=True)
    return {"evaluation_pc": evaluation,
            "tracking_edm": {"eager": eager, "frozen": got, "agreement": how}}


def frozen_samplers(dev, card, pts: np.ndarray, eager14: dict, nocs: str, seg: str,
                    chunks: int, instances: int):
    """Phase 17: every sampler through the frozen programs."""
    t0 = time.perf_counter()
    out = {"serving": frozen_sampler_serving(dev, card, pts, eager14)}
    out["trajectories"] = frozen_trajectories_and_likelihood(dev, card, pts)
    out["runners"] = frozen_sampler_runners(dev, card, nocs, seg, chunks, instances)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17 took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: data parallelism through the port's group code (parallel/)
# ---------------------------------------------------------------------------
DP_SCORE_STEPS, DP_ENERGY_ITERS = 2, 1  # per arm, at the released recipe's width
DP_TOL = 1e-3  # phase 18: |a - b| / (1 + |b|) against the single-process run
DP_MAX_TIE_ROWS = 4  # phase 18: served rows whose energy ranking may differ (near ties)


def _scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size else 0.0


def _dp_work(group, spec):
    """Phase 18, one rank of a group (``group`` None: the single process):
    DP_SCORE_STEPS score steps and DP_ENERGY_ITERS energy-with-ranking
    iterations on this rank's rows of the global batches, then one request
    of the serving pipeline under Heun and under RK45, all inside
    ``parallel.sharded``; every collective timed between two CUDA events
    (gloo's include their copies through the host), the launches read
    around each step, iteration and request.  Returns this rank's numbers
    and results."""
    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.data.process import process_batch
    from genpose_tpu_torch.diffusion import samplers
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.parallel import group as parallel
    from genpose_tpu_torch.runners.serving import InferencePipeline
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import load_checkpoint

    dev = group.device if group is not None else torch.device(spec["device"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # each collective between two CUDA events on the current stream (the
    # host clock on the CPU), read once the metered call has synchronised
    spans = []
    real_all_reduce = parallel.all_reduce_

    def timed_all_reduce(t, g):
        if not cuda:
            t0 = time.perf_counter()
            out = real_all_reduce(t, g)
            spans.append(time.perf_counter() - t0)
            return out
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = real_all_reduce(t, g)
        ev[1].record()
        spans.append(ev)
        return out

    parallel.all_reduce_ = timed_all_reduce
    attempts = []  # RK45 attempts of each integration
    real_integrate = samplers.integrate_adaptive

    def counted_integrate(*args):
        res = real_integrate(*args)
        attempts.append(res[1])
        return res

    samplers.integrate_adaptive = counted_integrate
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def metered(fn):
        sync()
        fps_cuda.launches = ball_query_cuda.launches = 0
        spans.clear()
        attempts.clear()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        reduce_s = sum(e[0].elapsed_time(e[1]) / 1e3 if cuda else e for e in spans)
        return out, {"s": secs, "all_reduce_s": reduce_s, "collectives": len(spans),
                     "rk45_attempts": list(attempts),
                     "launches": {"fps": fps_cuda.launches,
                                  "ball_query": ball_query_cuda.launches}}

    def agent(cfg, mode, path):
        a = PoseAgent(cfg, mode, device=dev, steps_per_epoch=100)
        load_checkpoint(path, a, load_model_only=False)
        return a

    out = {"steps": [], "serving": {}}
    cfg = Config(seed=0, sampler_mode=("ode_adaptive",), batch_size=spec["bs"],
                 num_points=spec["n_points"])
    score = agent(cfg, "score", spec["ckpt"]["score"])
    energy = agent(cfg, "energy", spec["ckpt"]["energy"])
    gen = torch.Generator(device=dev).manual_seed(0)
    with parallel.sharded(group):
        for i, raw in enumerate(spec["raws"]):
            batch = process_batch(parallel.shard_batch(group, raw), cfg.pose_mode, gen,
                                  cfg.pts_aug, device=dev)
            if i < DP_SCORE_STEPS:
                losses, meter = metered(lambda: score.train_step(batch, gen))
                kind = "score"
            else:  # the trained score agent as the teacher, K=5 candidates by RK45
                def iteration():
                    cands, geom = score.sample(batch, generator=gen, repeat_num=5,
                                               num_steps=cfg.sampling_steps,
                                               return_geometry=True)
                    return energy.train_step_energy(batch, cands, gen, geometry=geom)

                losses, meter = metered(iteration)
                kind = "energy"
            losses = parallel.mean_over_ranks(losses, group)
            out["steps"].append(dict(meter, kind=kind,
                                     losses={k: float(v) for k, v in losses.items()}))
    out["score_state"] = {k: v.detach().cpu().numpy() for k, v in score.params().items()}
    out["energy_state"] = {k: v.detach().cpu().numpy() for k, v in energy.params().items()}
    out["stats"] = {k: v.detach().cpu().numpy() for k, v in score.model.state_dict().items()
                    if "running" in k}
    for sampler in ("ode", "ode_adaptive"):
        scfg = Config(batch_size=spec["serve_bs"], eval_repeat_num=spec["K"],
                      num_points=spec["n_points"], T0=0.55, sampling_steps=spec["heun_steps"],
                      sampler_mode=(sampler,))
        pipe = InferencePipeline(scfg, device=dev, group=group,
                                 score_ckpt=spec["ckpt"]["serve_score"],
                                 energy_ckpt=spec["ckpt"]["serve_energy"])
        pred, meter = metered(lambda: pipe.predict(
            spec["pts"], generator=torch.Generator(device=dev).manual_seed(1)))
        out["serving"][sampler] = dict(meter, pred=pred)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    parallel.all_reduce_ = real_all_reduce
    samplers.integrate_adaptive = real_integrate
    return out


def _served_gap(a: dict, b: dict, keep: int):
    """The largest scaled gap between two served results of the same
    request, and the rows whose ranking differs.  The hypotheses are ranked
    by energy, rotations and translations apart, so two energies that float
    noise leaves in a near tie may swap places: each channel's hypotheses
    and energies are matched by the hypothesis (sorted by its first
    coordinate) before they are compared, and the pooled and best poses
    are compared on the rows where both results keep the same top ``keep``
    and the same best hypothesis in both channels."""
    d = a["sorted_hypotheses"].shape[-1]
    gaps, same = [], np.ones(a["pred_pose"].shape[0], bool)
    for cols, ch in ((slice(0, d - 3), 0), (slice(d - 3, d), 1)):
        xa, xb = a["sorted_hypotheses"][..., cols], b["sorted_hypotheses"][..., cols]
        ea, eb = a["energy"][..., ch], b["energy"][..., ch]
        ida, idb = np.argsort(xa[..., 0], axis=1), np.argsort(xb[..., 0], axis=1)
        gaps += [_scaled(np.take_along_axis(xa, ida[..., None], 1),
                         np.take_along_axis(xb, idb[..., None], 1)),
                 _scaled(np.take_along_axis(ea, ida, 1), np.take_along_axis(eb, idb, 1))]
        same &= ((ida < keep) == (idb < keep)).all(axis=1) & (
            np.argmin(ida, axis=1) == np.argmin(idb, axis=1))
    if same.any():
        pa, pb = a["pred_pose"][same], b["pred_pose"][same]
        sign = np.where(np.sum(pa[:, :4] * pb[:, :4], axis=1, keepdims=True) < 0, -1.0, 1.0)
        gaps += [_scaled(pa[:, :4] * sign, pb[:, :4]), _scaled(pa[:, 4:], pb[:, 4:])]
        ba, bb = a["best_pose"][same], b["best_pose"][same]
        sign = np.where(np.sum(ba[:, :4] * bb[:, :4], axis=1, keepdims=True) < 0, -1.0, 1.0)
        gaps += [_scaled(ba[:, :4] * sign, bb[:, :4]), _scaled(ba[:, 4:], bb[:, 4:])]
    return max(gaps), int((~same).sum())


def _dp_check(label: str, runs, ref, chunks: int) -> dict:
    """Phase 18: every rank of an arm against the others and against the
    single-process run ``ref``; FPS 3 and ball query 3 launches per step,
    iteration and request chunk in every rank."""
    for r, run in enumerate(runs):
        for st in run["steps"]:
            want = {"fps": 3, "ball_query": 3}
            if st["launches"] != want:
                raise AssertionError(f"{label} rank {r} {st['kind']}: launches "
                                     f"{st['launches']}, expected {want}")
        for sampler, sv in run["serving"].items():
            want = {"fps": 3 * chunks, "ball_query": 3 * chunks}
            if sv["launches"] != want:
                raise AssertionError(f"{label} rank {r} serving {sampler}: launches "
                                     f"{sv['launches']}, expected {want}")
        for what in ("score_state", "energy_state"):
            for k, v in run[what].items():
                if not np.array_equal(v, runs[0][what][k]):
                    raise AssertionError(f"{label}: rank {r}'s {what} {k} differs from rank 0's")
    got = runs[0]
    gaps = {"losses": max(_scaled([v for st in got["steps"] for v in st["losses"].values()],
                                  [v for st in ref["steps"] for v in st["losses"].values()]),
                          0.0)}
    for what in ("score_state", "energy_state", "stats"):
        gaps[what] = max(_scaled(v, ref[what][k]) for k, v in got[what].items())
    ties = {}
    for sampler, sv in got["serving"].items():
        gaps[f"serving_{sampler}"], ties[sampler] = _served_gap(
            sv["pred"], ref["serving"][sampler]["pred"], int(0.6 * K))
    gaps["tie_rows"] = ties
    bad = {k: v for k, v in gaps.items() if k != "tie_rows" and not v <= DP_TOL}
    if any(n > DP_MAX_TIE_ROWS for n in ties.values()):
        bad["tie_rows"] = ties
    if bad:
        att = {"ranks": [[st["rk45_attempts"] for st in r["steps"]] +
                         [v["rk45_attempts"] for v in r["serving"].values()] for r in runs],
               "single": [st["rk45_attempts"] for st in ref["steps"]] +
                         [v["rk45_attempts"] for v in ref["serving"].values()]}
        raise AssertionError(f"{label}: against the single process {bad} > {DP_TOL} "
                             f"(all gaps {gaps}; RK45 attempts {att})")
    return gaps


def data_parallel(dev, card):
    """Phase 18: the group code on the card.  NCCL refuses two ranks on one
    card, so: (a) a group of one over NCCL (the single process's program
    under the group's set-up: every helper is the identity at world 1);
    (b) two ranks sharing the card over gloo (asked for by name; CUDA
    tensors through the host); (c) two cards over NCCL where the machine
    has them.  Each arm (spawned workers,
    ``parallel.launch``) against the single-process run of the same work on
    the same global batches, draws and weights.  Two ranks on one card
    measure that the program is right, not how it scales."""
    import tempfile

    from genpose_tpu_torch.config import Config
    from genpose_tpu_torch.parallel import group as parallel
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import save_checkpoint
    from genpose_tpu_torch.utils.weights import perturb_

    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    cfg = Config(seed=0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(OUT_DIR)) as tmp:
        ckpt = {}
        for name, mode, seed in (("score", "score", 11), ("energy", "energy", 12),
                                 ("serve_score", "score", 1), ("serve_energy", "energy", 2)):
            a = PoseAgent(cfg, mode, device=dev)
            perturb_(a.model, seed=seed)
            ckpt[name] = save_checkpoint(os.path.join(tmp, name), a, epoch=0)
            del a
        gen = torch.Generator(device=dev).manual_seed(5)
        pts = object_clouds(gen, B, N_POINTS, dev).cpu().numpy()
        pts += rng.uniform([-0.3, -0.3, 0.5], [0.3, 0.3, 1.2], size=(B, 1, 3)).astype(np.float32)
        spec = {"device": "cuda", "bs": B_TRAIN, "n_points": N_POINTS, "serve_bs": B, "K": K,
                "heun_steps": HEUN_STEPS, "ckpt": ckpt, "pts": pts,
                "raws": _raw_batches(rng, DP_SCORE_STEPS + DP_ENERGY_ITERS, B_TRAIN, N_POINTS)}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = _dp_work(None, spec)
        ref_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        arms = {"a_nccl_w1": (1, None), "b_gloo_w2_one_card": (2, "gloo")}
        if torch.cuda.device_count() >= 2:
            arms["c_nccl_w2"] = (2, None)
        result = {"single_process": dict(_dp_summary(ref), peak_mem_gb=ref["peak_mem_gb"]),
                  "single_process_s": ref_s}
        for name, (world, backend) in arms.items():
            t0 = time.perf_counter()
            runs = parallel.launch(_dp_work, world, "cuda", args=(spec,), backend=backend)
            arm_s = time.perf_counter() - t0
            gaps = _dp_check(f"phase 18 {name}", runs, ref, chunks=1)
            result[name] = dict(_dp_summary(runs[0]), world=world,
                                backend=backend or "nccl", gaps=gaps, wall_s=arm_s,
                                peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in runs],
                                launches_per_rank=[
                                    {"steps": [st["launches"] for st in r["steps"]],
                                     "serving": {s: v["launches"]
                                                 for s, v in r["serving"].items()}}
                                    for r in runs])
            s = result[name]
            print(f"phase 18 {name} (world {world}, {s['backend']}; global bs={B_TRAIN}, "
                  f"N={N_POINTS}, repeat {cfg.repeat_num}; serving bs={B}, K={K}): score steps "
                  f"{[round(x, 4) for x in s['score_step_s']]} s (all-reduce share "
                  f"{[round(x, 4) for x in s['score_all_reduce_share']]}), energy iteration "
                  f"{s['energy_iter_s']:.4f} s (share {s['energy_all_reduce_share']:.4f}); "
                  f"serving Heun-{HEUN_STEPS} {s['serving_s']['ode']:.4f} s, RK45 "
                  f"{s['serving_s']['ode_adaptive']:.4f} s; peak memory per rank "
                  f"{[round(x, 3) for x in s['peak_mem_gb_per_rank']]} GB; launches per rank "
                  f"{s['launches_per_rank']}; against one process {gaps} (<= {DP_TOL}); "
                  f"arm wall {arm_s:.1f} s; {card}", flush=True)
    sp = result["single_process"]
    print(f"phase 18 single process: score steps {[round(x, 4) for x in sp['score_step_s']]} s, "
          f"energy iteration {sp['energy_iter_s']:.4f} s, serving {sp['serving_s']}; peak "
          f"memory {sp['peak_mem_gb']:.3f} GB; {card}", flush=True)
    result["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18 took {result['seconds']:.1f} s", flush=True)
    return result


def _dp_summary(run) -> dict:
    score = [st for st in run["steps"] if st["kind"] == "score"]
    energy = [st for st in run["steps"] if st["kind"] == "energy"]
    return {"score_step_s": [st["s"] for st in score],
            "score_all_reduce_share": [st["all_reduce_s"] / st["s"] for st in score],
            "energy_iter_s": energy[0]["s"],
            "energy_all_reduce_share": energy[0]["all_reduce_s"] / energy[0]["s"],
            "losses": [st["losses"] for st in run["steps"]],
            "serving_s": {s: v["s"] for s, v in run["serving"].items()},
            "serving_all_reduce_s": {s: v["all_reduce_s"] for s, v in run["serving"].items()}}


# ---------------------------------------------------------------------------
# phase 19: utils/benchmarking.py's chained timer on the card
# ---------------------------------------------------------------------------
CHAIN_ITERS = {"geometry": 20, "frozen_heun": 2}


def benchmarking_module(dev, card, pts: np.ndarray, frozen_heun_s: float):
    """Phase 19: ``time_chain_marginal`` (CUDA events, chains of n and 2n
    calls interleaved, min of 3) over the three-stage geometry chain of the
    serving batch (FPS + ball query + grouping; the kernels) and over the
    frozen float32 Heun-500 request (``InferencePipeline._run``), beside
    phase 12's host-clock seconds for the same request."""
    from genpose_tpu_torch.models.pointnet2 import cls_msg_geometry
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.utils import benchmarking

    t_phase = time.perf_counter()
    x = torch.from_numpy(pts).to(dev)
    x = x - x.mean(dim=1, keepdim=True)
    out = {}
    fps_cuda.launches = ball_query_cuda.launches = 0
    per, env = benchmarking.time_chain_marginal(
        lambda p, g: cls_msg_geometry(p, "light"), x, None, CHAIN_ITERS["geometry"])
    calls = 1 + 3 * 3 * CHAIN_ITERS["geometry"]  # warm-up chain, then 3 x (n + 2n)
    launches = {"fps": fps_cuda.launches, "ball_query": ball_query_cuda.launches}
    if launches != {"fps": 3 * calls, "ball_query": 3 * calls}:
        raise AssertionError(f"phase 19 geometry chain: launches {launches}, expected "
                             f"{3 * calls} each")
    out["geometry"] = {"per_iter_s": per, "envelope_s": env, "iters": CHAIN_ITERS["geometry"],
                       "launches": launches}
    pipe = make_pipeline(dev, sampler_mode=("ode",)).freeze().warmup()
    per, env = benchmarking.time_chain_marginal(lambda p, g: pipe._run(p, g), x,
                                                torch.Generator(device=dev).manual_seed(1),
                                                CHAIN_ITERS["frozen_heun"])
    out["frozen_heun"] = {"per_iter_s": per, "envelope_s": env,
                          "iters": CHAIN_ITERS["frozen_heun"],
                          "phase12_host_clock_s": frozen_heun_s}
    del pipe
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19 time_chain_marginal (CUDA events): geometry chain (bs={B}, N={N_POINTS}, "
          f"light, 3 FPS + 3 ball query) {out['geometry']['per_iter_s'] * 1e3:.4f} ms per call, "
          f"envelope {out['geometry']['envelope_s'] * 1e3:.4f} ms; frozen f32 Heun-{HEUN_STEPS} "
          f"request (bs={B}, K={K}) {out['frozen_heun']['per_iter_s']:.4f} s per call, "
          f"envelope {out['frozen_heun']['envelope_s'] * 1e3:.3f} ms (phase 12 host clock "
          f"{frozen_heun_s:.4f} s); took {out['seconds']:.1f} s; {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: the host C helper (native/) on the data path
# ---------------------------------------------------------------------------
HELPER_ROI_SIDES = (120, 240, 440)  # square ROIs of the helper's timing, half the pixels valid
HELPER_REPEATS = {"c": 40, "python": 8}  # calls per timed turn of each path
# the batch of the loader whose first batch goes through both paths: the
# config's 192 until phase 21 came, cut to keep the script near 1000 s (the
# thread loader fetches ~18 samples/s, and the prefetch doubles the calls)
HELPER_BATCH = 48


@contextlib.contextmanager
def no_native(on: bool = True):
    """Within the block (when ``on``), ``GENPOSE_NO_NATIVE=1``: the data path
    takes the plain Python stream."""
    from genpose_tpu_torch import native

    saved = os.environ.get(native.DISABLE_ENV)
    if on:
        os.environ[native.DISABLE_ENV] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(native.DISABLE_ENV, None)
        else:
            os.environ[native.DISABLE_ENV] = saved


def _first_loader_batch(tree: str, plain: bool):
    """The first batch of the train loader (thread mode, the config's
    defaults but a batch of HELPER_BATCH), with the inputs of each ``backproject_and_sample`` call it
    made (the generator copied before the call) and the number of the
    helper's calls."""
    from genpose_tpu_torch import native
    from genpose_tpu_torch.config import get_config
    from genpose_tpu_torch.data import nocs
    from genpose_tpu_torch.data.loader import get_data_loaders_from_cfg

    calls, helper_calls = [], []  # list.append is atomic: the loader's threads share them
    real, real_native = nocs.backproject_and_sample, native.backproject_sample

    def recorded(depth, K, xymap, mask, n_pts, rng, scale=1.0):
        calls.append((depth, K, xymap, mask, n_pts, copy.deepcopy(rng), scale))
        return real(depth, K, xymap, mask, n_pts, rng, scale)

    def counted(*args, **kwargs):
        helper_calls.append(1)
        return real_native(*args, **kwargs)

    nocs.backproject_and_sample, native.backproject_sample = recorded, counted
    try:
        with no_native(plain):
            cfg = get_config(["--data_path", tree, "--loader_mode", "thread",
                              "--batch_size", str(HELPER_BATCH)])
            loader = get_data_loaders_from_cfg(cfg, ["train"])["train_loader"]
            it = iter(loader)
            batch = next(it)
            it.close()
            loader.close()
            # the producer and its pool are joined: no call is still running
            return batch, list(calls), len(helper_calls)
    finally:
        nocs.backproject_and_sample, native.backproject_sample = real, real_native


def _hold_entry_points(calls, clouds: np.ndarray):
    """Each of the helper's five entry points against its plain version on
    the recorded inputs (and FPS on the batch's clouds), bit for bit."""
    from genpose_tpu_torch import native
    from genpose_tpu_torch.data import dataset_utils as du
    from genpose_tpu_torch.ops.pointcloud import farthest_point_sample_ref

    checked = {"depth_mask_to_pcl": 0, "sample_points": 0, "backproject_sample": 0,
               "fps": 0, "fps_batch": 0}
    for depth, K, xymap, mask, n_pts, rng, scale in calls:
        fx, fy, cx, cy, s = du._intrinsics(K, scale)
        roi = (depth, mask, xymap[0], xymap[1], fx, fy, cx, cy)
        pcl = du.depth_mask_to_pcl_ref(*roi, s)
        if not np.array_equal(native.depth_mask_to_pcl(*roi, s), pcl):
            raise AssertionError("depth_mask_to_pcl != depth_mask_to_pcl_ref on a loader ROI")
        seed = int(copy.deepcopy(rng).integers(0, 2**63 - 1))
        want = du._native_sample(pcl, n_pts, seed)
        if not np.array_equal(native.sample_points(pcl, n_pts, seed), want):
            raise AssertionError("sample_points != _native_sample on a loader cloud")
        k, got = native.backproject_sample(*roi, s, n_pts, seed)
        ref_k, ref = du.backproject_and_sample_ref(depth, K, xymap, mask, n_pts,
                                                   copy.deepcopy(rng), scale)
        if k != ref_k or k != pcl.shape[0] or not np.array_equal(got, ref):
            raise AssertionError("backproject_sample != backproject_and_sample_ref")
        for name in ("depth_mask_to_pcl", "sample_points", "backproject_sample"):
            checked[name] += 1
    npoint = clouds.shape[1] // 2
    want = farthest_point_sample_ref(torch.from_numpy(clouds), npoint).numpy()
    if not np.array_equal(native.fps(clouds, npoint), want):
        raise AssertionError("fps (batch) != farthest_point_sample_ref on the loader batch")
    checked["fps_batch"] = 1
    for cloud, w in zip(clouds, want):
        if not np.array_equal(native.fps(cloud, npoint), w):
            raise AssertionError("fps (one cloud) != farthest_point_sample_ref")
        checked["fps"] += 1
    return checked


def _helper_timing():
    """ms per call of ``backproject_and_sample`` through the helper and the
    plain Python stream on square ROIs (half the pixels valid, N=1024, the
    loader's mm -> m scale), in turns python, c, c, python; medians."""
    from genpose_tpu_torch.data import dataset_utils as du

    rng = np.random.default_rng(0)
    K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]], np.float32)
    out = {}
    for side in HELPER_ROI_SIDES:
        depth = (rng.integers(300, 1500, (side, side))
                 * (rng.random((side, side)) < 0.5)).astype(np.float32)[None]
        mask = np.ones_like(depth)
        coord = du.get_2d_coord_np(side, side).astype(np.float32)
        times = {"c": [], "python": []}
        for path in ("python", "c", "c", "python"):
            fn = du.backproject_and_sample_ref if path == "python" else du.backproject_and_sample
            gen = np.random.default_rng(1)
            t0 = time.perf_counter()
            for _ in range(HELPER_REPEATS[path]):
                n_valid, _ = fn(depth, K, coord, mask, N_POINTS, gen, 1e-3)
            times[path].append((time.perf_counter() - t0) / HELPER_REPEATS[path] * 1e3)
        out[f"{side}x{side}"] = {"valid": int(n_valid), "c_ms": float(np.median(times["c"])),
                                 "python_ms": float(np.median(times["python"])),
                                 "turns_ms": times}
    return out


def build_host_helper() -> dict:
    """Phase 20, first: build the host C helper from its source (at the
    start of the run, before phase 15's loaders call it)."""
    from genpose_tpu_torch import native

    if native.disabled():
        raise AssertionError(f"{native.DISABLE_ENV} is set: phase 20 drives the helper")
    found = native.library_path().exists()
    t0 = time.perf_counter()
    lib = native.build()
    native.get_lib()
    out = {"library": str(lib.relative_to(Path(__file__).resolve().parent)),
           "build_s": time.perf_counter() - t0, "built_here": not found}
    print(f"host C helper {out['library']} {'built' if not found else 'found'} in "
          f"{out['build_s']:.3f} s", flush=True)
    return out


def host_helper(card: str, tree: str, cli: dict, helper_build: dict):
    """Phase 20: the host C helper (``genpose_tpu_torch/native``, built by
    ``build_host_helper``): the train loader's first batch fetched through
    it and through the plain Python stream (``GENPOSE_NO_NATIVE=1``), bit for bit,
    each entry point held against its plain version on that batch's
    inputs, ms per call of both paths, and one sample's host split under
    the plain stream beside phase 15's (through the helper)."""
    t_phase = time.perf_counter()
    out = dict(helper_build)
    batch, calls, helper_calls = _first_loader_batch(tree, plain=False)
    plain_batch, plain_calls, plain_helper_calls = _first_loader_batch(tree, plain=True)
    if not calls or helper_calls != len(calls) or plain_helper_calls != 0:
        raise AssertionError(f"helper calls {helper_calls} for {len(calls)} samples (plain "
                             f"stream: {plain_helper_calls} for {len(plain_calls)})")
    for k in batch:
        a, b = batch[k], plain_batch[k]
        if not (a == b if k == "path" else np.array_equal(a, b) and a.dtype == b.dtype):
            raise AssertionError(f"the loader batch differs at {k!r} between the helper and "
                                 f"the plain stream")
    out["checked"] = _hold_entry_points(calls, np.ascontiguousarray(batch["pcl_in"]))
    out["samples"] = {"batch": len(batch["path"]), "calls": len(calls)}
    out["ms_per_call"] = _helper_timing()
    with no_native():
        out["sample_host_ms_plain_stream"] = sample_host_split(tree)
    out["sample_host_ms_helper"] = cli["sample_host_ms"]
    out["loader_helper"] = cli["loader"]
    out["seconds"] = time.perf_counter() - t_phase
    key = "back-projection + sampling"
    print(f"phase 20 host C helper ({out['library']}): the first train batch "
          f"({out['samples']['batch']} samples, {len(calls)} calls, thread loader) equal through the helper and the plain stream; entry points equal their plain "
          f"versions {out['checked']}; ms per call (N={N_POINTS}, half the pixels valid), "
          f"helper / Python stream: "
          + ", ".join(f"{k} {v['c_ms']:.4f} / {v['python_ms']:.4f}"
                      for k, v in out["ms_per_call"].items())
          + f"; a sample's {key} {out['sample_host_ms_helper'][key]:.3f} ms of "
          f"{out['sample_host_ms_helper']['total']:.3f} (helper, phase 15) against "
          f"{out['sample_host_ms_plain_stream'][key]:.3f} of "
          f"{out['sample_host_ms_plain_stream']['total']:.3f} (plain stream); loaders with the "
          f"helper (phase 15): "
          + "; ".join(f"{m} {r['samples_per_s']:.2f} samples/s"
                      for m, r in out["loader_helper"].items())
          + f"; took {out['seconds']:.1f} s; {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 21: the convergence check (genpose_tpu_torch/tools/convergence_check.py)
# ---------------------------------------------------------------------------
CONV_EVAL_EVERY = 250  # steps between the criterion's evaluations
# the cap on score steps: float32 runs reached the criterion at steps 5,750-
# 6,750 on the H100 (PERF.md), the JAX tool's float32 run at 8,500 on its own
# chip, under a cap of 9,000
CONV_MAX_STEPS = 9000


def convergence(dev, card):
    """Phase 21: ``tools/convergence_check.py`` at full width, float32: the
    score net trained on the 4-object task (bs=64, N=1024, repeat 20, Adam
    lr 1e-3, warm-up 100) until its Heun-100 samples from the EMA shadow lie
    under the criterion (rotation 41 deg and translation 3.9 cm, checked
    every CONV_EVAL_EVERY steps, at most CONV_MAX_STEPS), the energy net with
    the ranking loss (``ENERGY_ITERS`` iterations, the JAX test's bounds),
    both saved and served frozen through ``InferencePipeline(score_ckpt=,
    energy_ckpt=)`` (K=50, Heun-100, top 60% pooled) on 64 held-out clouds:
    the pooled poses must meet the criterion.  FPS 3 + ball query 3 in every
    score step, evaluation, energy iteration and served request."""
    from genpose_tpu_torch.tools import convergence_check as cc
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import save_checkpoint

    t_phase = time.perf_counter()
    k = cc.knobs({})  # the tool's defaults, whatever the environment holds
    k.update(eval_every=CONV_EVAL_EVERY, n_steps=CONV_MAX_STEPS)
    clouds = torch.from_numpy(cc.make_task())
    out_dir = OUT_DIR / "convergence"

    def log(line):
        if not line.startswith(("step ", "energy iteration ")):
            print(f"phase 21 {line}", flush=True)

    three = {"fps": 3, "ball_query": 3}
    score = PoseAgent(cc.score_config(k), "score", device=dev, steps_per_epoch=100)
    run = cc.train_score(score, clouds, k, log)
    if run["met_at"] is None:
        raise AssertionError(f"phase 21: the criterion was not met within {CONV_MAX_STEPS} "
                             f"steps: {run['evals'][-1]}")
    if run["launches_per_step"] != three or run["launches_per_eval"] != three:
        raise AssertionError(f"phase 21 launches: {run['launches_per_step']} per step, "
                             f"{run['launches_per_eval']} per evaluation")
    score_ckpt = save_checkpoint(str(out_dir / "score"), score, 0)
    del score
    torch.cuda.empty_cache()
    energy, en = cc.train_energy_ranking(cc.energy_config(k), clouds, cc.ENERGY_ITERS, dev, log)
    if en["launches_per_iteration"] != three:
        raise AssertionError(f"phase 21 energy launches {en['launches_per_iteration']}")
    energy_ckpt = save_checkpoint(str(out_dir / "energy"), energy, 0)
    del energy
    torch.cuda.empty_cache()
    served = cc.serve_trained(cc.serving_config(k), score_ckpt, energy_ckpt, clouds, dev, log)
    cc.check_served(served, k, criterion=True)
    for arm in ("trained", "untrained"):
        if served[arm]["launches"] != three:
            raise AssertionError(f"phase 21 served {arm}: launches {served[arm]['launches']}")
    torch.cuda.empty_cache()
    e0, e1 = run["evals"][0], run["evals"][-1]
    out = {"score": run, "energy": en, "served": served,
           "seconds": time.perf_counter() - t_phase}
    t, u = served["trained"], served["untrained"]
    print(f"phase 21 convergence (bs={k['batch_size']}, N={cc.N_POINTS}, repeat 20, Adam lr "
          f"{k['lr']:g}, float32): criterion (rot < {k['rot_crit']} deg, trans < "
          f"{k['trans_crit']} cm) met at step {run['met_at']} after {run['train_s']:.1f} s of "
          f"training = {run['samples_per_s']:.1f} samples/s (first step {run['first_step_s']:.2f}"
          f" s and {len(run['evals']) - 1} evaluations {run['eval_s']:.1f} s left out); DSM "
          f"{run['dsm_first']:.3f} -> {run['dsm_last']:.3f}; rot {e0['rot_deg']:.2f} -> "
          f"{e1['rot_deg']:.2f} deg, trans {e0['trans_m'] * 100:.2f} -> "
          f"{e1['trans_m'] * 100:.2f} cm; energy ranking {en['ranking_first10']:.3f} -> "
          f"{en['ranking_last10']:.3f}, best above worst in {en['order_fraction']:.3f}, "
          f"{en['s_per_iteration']:.4f} s per iteration; served frozen pooled rot "
          f"{t['pooled']['rot_deg']:.2f} deg trans {t['pooled']['trans_cm']:.2f} cm, best-energy "
          f"rot {t['best']['rot_deg']:.2f} deg trans {t['best']['trans_cm']:.2f} cm (untrained "
          f"pooled {u['pooled']['rot_deg']:.2f} deg, {u['pooled']['trans_cm']:.2f} cm), request "
          f"{t['request_s']:.4f} s; FPS + ball query per score step "
          f"{run['launches_per_step']}, per energy iteration {en['launches_per_iteration']}, per "
          f"request {t['launches']}; took {out['seconds']:.1f} s; {card}", flush=True)
    return out


def ptxas(source: str, name_of):
    """Registers and spill bytes of each kernel of ``csrc/<source>``, from one
    ``nvcc -Xptxas -v`` compile of the file with the build's flags;
    ``name_of`` maps a mangled entry name to a readable one (None: skip)."""
    import re
    import subprocess
    import tempfile

    from genpose_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(_build.CSRC_DIR / source), "-o", str(Path(tmp) / "kernel.o")]
        log = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             check=True).stdout
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = name_of(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def score_head_ptxas():
    """Registers and spill bytes of ``csrc/score_head.cu``'s kernels."""
    return ptxas("score_head.cu", lambda fn: (
        "score_head_prep" if "score_head_prep" in fn else
        f"score_head_kernel<{3 if 'ILi3E' in fn else 0}>" if "score_head_kernel" in fn
        else None))


def sa_stage_ptxas():
    """Registers and spill bytes of each instantiation of
    ``csrc/sa_stage.cu``, named by its (NS, G, C, N0, N1, N2, THREADS)."""
    import re

    def name_of(fn):
        if "sa_stage_kernel" not in fn:
            return None
        return "sa_stage_kernel<" + ",".join(re.findall(r"Li(\d+)E", fn)) + ">"

    return ptxas("sa_stage.cu", name_of)


def events_ms(fn, calls: int) -> float:
    """Milliseconds a call by CUDA events around ``calls`` back-to-back calls
    after a warm one, without autograd."""
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def eval_cell_pose_gap(dev, seed: int):
    """One frozen request of the benchmark's ``genpose_light.eval_b256``
    cell through its own harness (weights, clouds and draws from ``seed``),
    checked against ``portbench/reference``: (numbers, the cell's limits)."""
    root = Path(__file__).resolve().parent / "portbench"
    sys.path.insert(0, str(root))
    try:
        from harness import common, serve

        cell, config, traffic = common.cell("genpose_light.eval_b256")
        d = serve.Driver(config, {**traffic, "check_units": 1}, dev, seed, common.Spans(dev))
        d.setup()
        d.start()
        d.unit(0)
        d.spans.unwrap()
        d.close(1)
        torch.cuda.empty_cache()
        return d.check(), cell["limits"]
    finally:
        sys.path.remove(str(root))


def score_head_path(dev, card):
    """Phase 22: the fused score head at the evaluation shape."""
    from genpose_tpu_torch.diffusion.sde import init_sde
    from genpose_tpu_torch.models.scorenet import PoseScoreNet
    from genpose_tpu_torch.ops import score_head_cuda as sh
    from genpose_tpu_torch.utils.weights import perturb_

    ptxas = score_head_ptxas()
    rows = 256 * K
    net = perturb_(PoseScoreNet(init_sde("ve").marginal_prob), seed=22, scale=0.05)
    net = net.to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(22)
    fp = net.precompute(torch.randn(256, 1024, generator=g, device=dev).relu())
    fp = fp.repeat_interleave(K, dim=0)
    x = torch.randn(rows, 9, generator=g, device=dev)
    t = torch.full((1, 1), EVAL_T0, device=dev)
    _, std = net.marginal_prob_fn(None, t)
    std = std.reshape(1, 1)
    with torch.no_grad():
        got = sh.score_head(net.trunk, fp, x, t, std)
        again = sh.score_head(net.trunk, fp, x, t, std)
        want = sh.score_head_ref(net.trunk, fp, x, t, std)
    torch.cuda.synchronize()
    gap = float((got - want).abs().max() / want.abs().max())
    if gap > SCORE_HEAD_TOL or not torch.equal(got, again):
        raise AssertionError(f"score head kernel: gap {gap} (limit {SCORE_HEAD_TOL}), "
                             f"two calls equal {torch.equal(got, again)}")

    def kernels():
        with torch.no_grad():
            sh.score_head(net.trunk, fp, x, t, std)

    kernel_ms = events_ms(kernels, SCORE_HEAD_CALLS)
    score_from_ms = events_ms(lambda: net.score_from(fp, x, t), SCORE_HEAD_CALLS)
    plain_ms = events_ms(lambda: sh.score_head_ref(net.trunk, fp, x, t, std), SCORE_HEAD_CALLS)
    head_dev_ms = device_ms(kernels, 50, "score_head_kernel")
    prep_dev_ms = device_ms(kernels, 50, "score_head_prep")
    T, H, O = net.trunk.tails.num_tails, net.trunk.tails.hidden, net.trunk.tails.out_dim
    NT = T * H
    macs = rows * (9 * 256 + 256 * 256 + 256 * NT + NT * O) + 128 * 128 + 128 * NT
    weights = 128 * 128 + 128 + 256 * 9 + 256 + 256 * 256 + 256 + 128 * NT + 256 * NT + NT \
        + NT * O + T * O + 64
    n_bytes = 4 * (rows * NT + rows * 9 + rows * T * O + weights)
    bnd, by = bound_ms(n_bytes, 2 * macs)
    shape = sh.launch_shape(rows, torch.cuda.get_device_properties(dev).multi_processor_count,
                            NT, O)
    numbers, limits = eval_cell_pose_gap(dev, SCORE_HEAD_SEED)
    if not numbers.get("pose_gap", float("inf")) <= limits["pose_gap"]:
        raise AssertionError(f"eval cell request: {numbers} against {limits}")
    out = {"rows": rows, "gap": gap, "kernel_ms": kernel_ms, "score_from_ms": score_from_ms,
           "plain_ms": plain_ms, "head_device_ms": head_dev_ms, "prep_device_ms": prep_dev_ms,
           "bound_ms": bnd, "bound_by": by, "ops": 2 * macs, "bytes": n_bytes,
           "launch": dict(zip(("warps", "rows_per_block", "blocks", "smem_bytes"), shape)),
           "ptxas": ptxas, "eval_cell": {"seed": SCORE_HEAD_SEED, **numbers, "limits": limits}}
    print(f"score head (rows={rows}, t={EVAL_T0}): kernel gap {gap:.3e} <= {SCORE_HEAD_TOL}; "
          f"kernel pair {kernel_ms:.4f} ms, score_from {score_from_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms by events; device head {_ms(head_dev_ms)}, prep "
          f"{_ms(prep_dev_ms)}; bound {bnd:.4f} ms ({by}); launch {out['launch']}; ptxas "
          f"{ptxas}; eval cell request pose_gap {numbers['pose_gap']:.3e} (limit "
          f"{limits['pose_gap']}), energy_gap {numbers.get('energy_gap')}; {card}", flush=True)
    return out


def sa_stage_path(dev, card):
    """Phase 23: the eval-mode grouped SA stage kernel at the serving shape
    (256 clouds of the light encoder): each stage 0-2 radius against the
    plain chain, its device time beside its float32 bound, one encoder pass
    fused and plain, registers and spills, and one request of the eval
    cell through its harness."""
    from genpose_tpu_torch.models.pointnet2 import Pointnet2ClsMSG, cls_msg_geometry
    from genpose_tpu_torch.ops import sa_stage_cuda as sk
    from genpose_tpu_torch.utils.weights import perturb_

    regs = sa_stage_ptxas()
    enc = perturb_(Pointnet2ClsMSG("light"), seed=23, scale=0.05)
    enc = enc.to(dev).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(23)
    clouds = 256
    pts = object_clouds(gen, clouds, N_POINTS, dev)
    geoms = cls_msg_geometry(pts, "light")
    rows, feats = [], None
    for k in range(3):
        sa, g = getattr(enc, f"sa_{k}"), geoms[k]
        outs = []
        for i in range(sa.n_scales):
            mlp, gx, gi = getattr(sa, f"mlp_{i}"), g["grouped_xyz"][i], g["gidx"][i]
            Bc, M, S = gi.shape
            ws = sk.widths(mlp)
            out = torch.empty(Bc, M, ws[-1], device=dev)
            kern = functools.partial(sk.sa_stage, mlp, gx, feats, gi, out, 0)
            plain = functools.partial(sk.sa_stage_ref, mlp, gx, feats, gi)
            with torch.no_grad():
                kern()
                want = plain()
                again = out.clone()
                kern()
            torch.cuda.synchronize()
            gap = float((again - want).abs().max() / want.abs().max())
            if gap > SA_STAGE_TOL or not torch.equal(out, again):
                raise AssertionError(f"sa stage {k} radius {i}: gap {gap} (limit "
                                     f"{SA_STAGE_TOL}), two calls equal {torch.equal(out, again)}")
            c_in = 3 + (0 if feats is None else feats.shape[-1])
            macs = Bc * M * S * (c_in * ws[0] + ws[0] * ws[1] + ws[1] * ws[2])
            weights = c_in * ws[0] + ws[0] * ws[1] + ws[1] * ws[2] + 4 * sum(ws)
            n_bytes = 4 * (Bc * M * S * 4 + (0 if feats is None else feats.numel())
                           + Bc * M * ws[-1] + weights)
            bnd, by = bound_ms(n_bytes, 2 * macs)
            rows.append(row(f"stage {k} radius {i} ({S} x {c_in} -> {ws})",
                            events_ms(kern, SA_STAGE_CALLS), events_ms(plain, SA_STAGE_CALLS),
                            n_bytes, 2 * macs, gap=gap,
                            device_ms=device_ms(kern, SA_STAGE_CALLS, "sa_stage_kernel")))
            outs.append(want)
        feats = torch.cat(outs, dim=-1)
    dev_total = None if any(r["device_ms"] is None for r in rows) else sum(
        r["device_ms"] for r in rows)
    bound_total = sum(r["bound_ms"] for r in rows)

    def encoder(grad: bool):  # grad enabled (no parameter needs it): the plain stages
        with torch.set_grad_enabled(grad):
            return enc(pts, geometry=geoms)

    with torch.no_grad():
        fused_feat = encoder(False)
        plain_feat = encoder(True)
    enc_gap = float((fused_feat - plain_feat).abs().max() / plain_feat.abs().max())
    pass_ms = {"fused": events_ms(lambda: encoder(False), SA_STAGE_CALLS),
               "plain": events_ms(lambda: encoder(True), SA_STAGE_CALLS)}
    numbers, limits = eval_cell_pose_gap(dev, SA_STAGE_SEED)
    if not numbers.get("pose_gap", float("inf")) <= limits["pose_gap"]:
        raise AssertionError(f"eval cell request: {numbers} against {limits}")
    spills = {n: r.get("spill_bytes", 0) for n, r in regs.items()}
    out = {"clouds": clouds, "radii": rows, "stages_device_ms": dev_total,
           "stages_bound_ms": bound_total, "encoder_pass_ms": pass_ms, "encoder_gap": enc_gap,
           "ptxas": regs, "eval_cell": {"seed": SA_STAGE_SEED, **numbers, "limits": limits}}
    for r in rows:
        print(f"phase 23 {r['shape']}: device {_ms(r['device_ms'])}, events {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"gap {r['gap']:.3e}", flush=True)
    print(f"phase 23 sa stage kernel ({clouds} clouds): stages 0-2 device {_ms(dev_total)} "
          f"against a {bound_total:.4f} ms float32 bound; one encoder pass (stages 0-3) "
          f"{pass_ms['fused']:.4f} ms fused, {pass_ms['plain']:.4f} ms plain (gap "
          f"{enc_gap:.3e}); ptxas {regs}; spills {spills}; eval cell request pose_gap "
          f"{numbers['pose_gap']:.3e} (limit {limits['pose_gap']}), energy_gap "
          f"{numbers.get('energy_gap')}; {card}", flush=True)
    if any(spills.values()):
        raise AssertionError(f"sa stage kernel spills registers: {spills}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from genpose_tpu_torch.ops import _build
    from genpose_tpu_torch.utils.benchmarking import card_line

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    print(f"built {lib.relative_to(_build.PKG_DIR.parent)} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    helper_build = build_host_helper()

    fps_rows, bq_rows, fused_rows, max_err = check_kernels(dev)
    for row in fps_rows + bq_rows + fused_rows:
        print(json.dumps(row), flush=True)
    fused_launches, chain_times, fused_profiled = fused_geometry_path(dev, card)
    phase22 = score_head_path(dev, card)
    torch.cuda.empty_cache()
    phase23 = sa_stage_path(dev, card)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(5)
    pts = object_clouds(gen, B, N_POINTS, dev).cpu().numpy()
    pts += rng.uniform([-0.3, -0.3, 0.5], [0.3, 0.3, 1.2], size=(B, 1, 3)).astype(np.float32)

    results, profiled = {}, {}
    for sampler in ("ode", "ode_adaptive"):
        pipe = make_pipeline(dev, sampler_mode=(sampler,))
        t0 = time.perf_counter()
        pipe.warmup()
        warm = time.perf_counter() - t0
        _, seconds, launches = drive(pipe, pts, sampler)
        results[sampler] = (seconds, launches)
        steps = f", {HEUN_STEPS} Heun steps" if sampler == "ode" else ", atol=rtol=1e-5"
        print(f"main path {sampler} (bs={B}, K={K}, N={N_POINTS}{steps}): "
              f"{seconds:.4f} s per request of {B} objects = {B / seconds:.2f} poses/s "
              f"(warmup {warm:.2f} s); launches {launches}; {card}", flush=True)
        profiled[sampler] = where_the_time_goes(pipe, pts, sampler)
        del pipe
        torch.cuda.empty_cache()

    cpu_gpu_agreement(dev)
    training = training_path(dev, card)
    torch.cuda.empty_cache()
    training_cpu_gpu_agreement(dev)
    torch.cuda.empty_cache()
    # phase 21 runs with the other training phases, before the process holds
    # the later phases' state: there its steps ran ~25% slower (PERF.md)
    phase21 = convergence(dev, card)
    torch.cuda.empty_cache()
    evaluation, nocs, agents, eval_ctx = evaluation_path(dev, card)
    tracking, eager_poses, eager_metrics = tracking_path(dev, card, nocs, agents)
    torch.cuda.empty_cache()
    eval_cpu_gpu_agreement(dev)
    frozen_arms = {"serving": frozen_serving(dev, card, pts),
                   "evaluation": frozen_evaluation(dev, card, evaluation, eval_ctx, agents),
                   "tracking": frozen_tracking(dev, card, nocs, agents, tracking, eager_poses,
                                               eager_metrics)}
    del agents
    torch.cuda.empty_cache()
    bf16 = bf16_evaluation_tracking(dev, card, evaluation, frozen_arms["evaluation"], eval_ctx,
                                    nocs)
    seg = eval_ctx["seg"]
    del eval_ctx
    torch.cuda.empty_cache()
    bf16["serving"] = bf16_serving(dev, card, pts, frozen_arms["serving"])
    bf16["cpu_gpu"] = bf16_cpu_gpu_agreement(dev)
    torch.cuda.empty_cache()
    bf16["training"] = bf16_training(dev, card, training["score"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase14 = {"released_ckpt": released_checkpoint_route(dev, card, pts)}
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase14["samplers"] = new_sampler_paths(dev, card, pts)
    t2 = time.perf_counter()
    phase14["cpu_gpu"] = new_sampler_cpu_gpu_agreement(dev, card)
    t3 = time.perf_counter()
    phase14["seconds"] = {"released_ckpt": t1 - t0, "samplers": t2 - t1, "cpu_gpu": t3 - t2,
                          "total": t3 - t0}
    print(f"phase 14 took {phase14['seconds']}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = training_cli_path(dev, card, training["score"]["s_per_step"])
    cli["seconds"] = time.perf_counter() - t0
    print(f"phase 15 took {cli['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    phase16 = new_configurations(dev, card, pts, training["score"]["s_per_step"])
    torch.cuda.empty_cache()
    phase17 = frozen_samplers(dev, card, pts, phase14["samplers"], nocs, seg,
                              evaluation["chunks"], evaluation["instances"])
    torch.cuda.empty_cache()
    phase18 = data_parallel(dev, card)
    torch.cuda.empty_cache()
    phase19 = benchmarking_module(dev, card, pts, frozen_arms["serving"]["ode"]["frozen_s"])
    torch.cuda.empty_cache()
    phase20 = host_helper(card, cli["tree"], cli, helper_build)

    fps_launches = results["ode"][1]["fps"]
    bq_launches = results["ode"][1]["ball_query"]

    def summary(name, source, replaces, rows, launches, **extra):
        """One path's worth of a kernel: the sum over its shapes on that path."""
        total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bytes", "ops")}
        for key in ("device_ms", "per_radius_bound_ms"):
            if key in rows[0]:
                vals = [r[key] for r in rows]
                extra[key] = None if None in vals else sum(vals)
        bnd, by = bound_ms(total["bytes"], total["ops"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_err, "ms": total["ms"],
                "plain_ms": total["plain_ms"], "bound_ms": bnd, "bound_by": by,
                "library_ms": None, "per_shape": rows, **extra}

    train_launches = {k: training["score"]["launches"][k] for k in ("fps", "ball_query")}

    def path_launches(k):
        """A kernel's launches in each run of the evaluation and tracking
        paths, of the frozen arms of phase 12, of the bfloat16 arms of
        phase 13, of the checkpoint and sampler paths of phase 14, of the
        training CLI's runs of phase 15, of phase 16's configurations, of
        phase 17's frozen samplers, of phase 18's ranks, of phase 19's
        chained geometry and of phase 21's convergence check."""
        fz = frozen_arms
        p17 = phase17
        return {"evaluation_stage2_launches": evaluation["launches"]["stage 2"][k],
                "evaluation_stage3_launches": evaluation["launches"]["stage 3"][k],
                "evaluation_chunks": evaluation["chunks"],
                "tracking_launches": tracking["launches"][k], "tracking_frames": tracking["frames"],
                "frozen_serving_launches": fz["serving"]["ode"]["launches"][k],
                "frozen_evaluation_stage2_launches": fz["evaluation"]["launches"]["stage 2"][k],
                "frozen_evaluation_stage3_launches": fz["evaluation"]["launches"]["stage 3"][k],
                "frozen_tracking_launches": fz["tracking"]["launches"][k],
                "bf16_serving_launches": bf16["serving"]["ode"]["launches"][k],
                "bf16_training_score_run_launches": bf16["training"]["launches"][k],
                "bf16_evaluation_stage2_launches": bf16["evaluation"]["launches"]["stage 2"][k],
                "bf16_evaluation_stage3_launches": bf16["evaluation"]["launches"]["stage 3"][k],
                "bf16_tracking_launches": bf16["tracking"]["launches"][k],
                "released_ckpt_serving_launches": phase14["released_ckpt"]["launches"][k],
                **{f"{name}_serving_launches": arm["launches"][k]
                   for name, arm in phase14["samplers"].items()},
                "likelihood_launches": phase14["cpu_gpu"]["likelihood"]["launches"][k],
                "training_cli_score_run_launches": cli["score"]["launches"][k],
                "training_cli_resumed_epochs_launches": [
                    r["launches"][k] for r in cli["score"]["resumed"]],
                "training_cli_energy_epoch_launches": cli["energy"]["launches"][k],
                **{f"training_cli_{flow}_launches": cli["flows"][flow]["launches"][k]
                   for flow in ("eval", "pred", "likelihood")},
                "new_config_serving_launches": {
                    name: arm["launches"][k] for name, arm in phase16["serving"].items()},
                "new_config_score_step_launches": {
                    name: arm["launches_per_step"] for name, arm in phase16["training"].items()},
                "msg_encoder_launches": phase16["msg_encoder"]["launches"][k],
                "training_cli_video_epoch_launches": cli["video"]["launches"][k],
                **{f"frozen_{arm}_serving_launches": r["launches"][k]
                   for arm, r in p17["serving"].items()},
                **{f"frozen_{arm}_launches": r["launches"][k]
                   for arm, r in p17["trajectories"].items()},
                "pc_evaluation_stage2_launches": {
                    a: p17["runners"]["evaluation_pc"]["launches"][a]["stage 2"][k]
                    for a in ("eager", "frozen")},
                "pc_evaluation_stage3_launches": {
                    a: p17["runners"]["evaluation_pc"]["launches"][a]["stage 3"][k]
                    for a in ("eager", "frozen")},
                "edm_tracking_launches": {
                    a: p17["runners"]["tracking_edm"][a]["launches"][k]
                    for a in ("eager", "frozen")},
                "data_parallel_launches_per_rank": {
                    arm: [{"steps": [st[k] for st in r["steps"]],
                           "serving": {s: v[k] for s, v in r["serving"].items()}}
                          for r in res["launches_per_rank"]]
                    for arm, res in phase18.items()
                    if isinstance(res, dict) and "launches_per_rank" in res},
                "benchmark_geometry_chain_launches": phase19["geometry"]["launches"][k],
                "convergence_score_step_launches": phase21["score"]["launches_per_step"][k],
                "convergence_evaluation_launches": phase21["score"]["launches_per_eval"][k],
                "convergence_energy_iteration_launches":
                    phase21["energy"]["launches_per_iteration"][k],
                "convergence_served_request_launches":
                    phase21["served"]["trained"]["launches"][k]}

    kernels = [
        summary("fps", "genpose_tpu_torch/csrc/fps.cu", "genpose_tpu/ops/fps_pallas.py:75",
                fps_rows, fps_launches, profiled_device_ms=profiled["ode"].get("fps"),
                path="serving request", training_score_run_launches=train_launches["fps"],
                new_config_shapes=phase16["fps_rows"], **path_launches("fps")),
        summary("ball_query", "genpose_tpu_torch/csrc/ball_query.cu",
                "genpose_tpu/ops/ball_query_pallas.py:84", bq_rows, bq_launches,
                profiled_device_ms=profiled["ode"].get("ball_query"),
                path="serving request",
                training_score_run_launches=train_launches["ball_query"],
                new_config_shapes=phase16["bq_rows"], **path_launches("ball_query")),
        summary("fps_bq_fused", "genpose_tpu_torch/csrc/fps_bq_fused.cu",
                "genpose_tpu/ops/fps_bq_fused.py:135", fused_rows, fused_launches,
                profiled_device_ms=fused_profiled,
                path="geometry chain (tools/bench_fused_geometry.py)", chain_ms=chain_times),
    ]
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"evaluation": evaluation, "tracking": tracking}), flush=True)
    print(json.dumps({"frozen": frozen_arms}), flush=True)
    print(json.dumps({"bf16": bf16}), flush=True)
    print(json.dumps({"checkpoints_and_samplers": phase14}), flush=True)
    print(json.dumps({"training_cli": cli}), flush=True)
    print(json.dumps({"new_configurations": {k: v for k, v in phase16.items()
                                             if k not in ("fps_rows", "bq_rows")}}), flush=True)
    print(json.dumps({"frozen_samplers": phase17}), flush=True)
    print(json.dumps({"data_parallel": phase18}), flush=True)
    print(json.dumps({"benchmarking": phase19}), flush=True)
    print(json.dumps({"host_helper": phase20}), flush=True)
    print(json.dumps({"convergence": phase21}), flush=True)
    print(json.dumps({"score_head": phase22}), flush=True)
    print(json.dumps({"sa_stage": phase23}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
