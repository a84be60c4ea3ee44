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
   card).

Checkpoints and metrics of phase 7, the trees and results of phases 9-12
and the converted checkpoints of phase 14 go under ``build/chip_smoke/`` in
the checkout.  The last lines are the training numbers, the evaluation and
tracking numbers, the frozen arms, the bfloat16 arms, the checkpoint and
sampler numbers, the card line, one JSON line describing each kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


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
    1x1-conv weights [out, in, 1, 1] and Linear weights [out, in], each tail
    one Linear over [pts_feat, t-or-sigma feat, pose_feat], BatchNorm as
    ``weight/bias/running_mean/running_var/num_batches_tracked``."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd = {}

    def linear(key, dense):
        sd[f"{key}.weight"] = t(np.asarray(dense["kernel"]).T)
        if "bias" in dense:
            sd[f"{key}.bias"] = t(dense["bias"])

    for sa, sa_p in params["encoder"].items():
        for mlp, mlp_p in sa_p.items():
            base = f"pts_encoder.SA_modules.{sa[3:]}.mlps.{mlp[4:]}"
            for name, leaf in mlp_p.items():
                j = name.split("_")[1]
                if name.startswith("dense"):
                    sd[f"{base}.layer{j}.conv.weight"] = t(np.asarray(leaf["kernel"]).T)[..., None, None]
                else:
                    bn, stats = f"{base}.layer{j}.bn.bn", batch_stats["encoder"][sa][mlp][name]
                    sd[f"{bn}.weight"], sd[f"{bn}.bias"] = t(leaf["scale"]), t(leaf["bias"])
                    sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"] = (t(stats["mean"]),
                                                                         t(stats["var"]))
                    sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
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
    if launches != {"fps": 3 * chunks, "ball_query": 3 * chunks}:
        raise AssertionError(f"{label}: main path launches {launches}, expected "
                             f"{3 * chunks} FPS and {3 * chunks} ball query")
    n = pts.shape[0]
    want_shapes = {"pred_pose": (n, 7), "best_pose": (n, 7),
                   "sorted_hypotheses": (n, pipe.K, 9), "energy": (n, pipe.K, 2)}
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


def cpu_gpu_agreement(dev):
    """Phase 5: a small batch on the card and on the CPU, same weights and noise.

    Coordinates lie on a 2^-10 m grid, so the zero-centering mean (a sum of
    1024 grid values, divided by 1024) is exact in float32 on both devices
    whatever the summation order, and FPS and ball query see identical
    inputs.  What remains is the GEMM summation order (cuBLAS vs the CPU
    BLAS), carried through 20 Heun steps, the ranking and the 4x4 eigen-solve:
    ~1e-6 relative per product, held to CPU_GPU_TOL.
    """
    import dataclasses

    from genpose_tpu_torch.runners.serving import InferencePipeline

    small = dict(batch_size=2, eval_repeat_num=4, sampling_steps=20)
    gpu = make_pipeline(dev, **small)
    cpu = InferencePipeline(gpu.cfg, device="cpu")
    cpu.score_agent.model.load_state_dict(gpu.score_agent.model.state_dict())
    cpu.energy_agent.model.load_state_dict(gpu.energy_agent.model.state_dict())
    noise = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 9)).astype(np.float32))
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
            raise AssertionError(f"CUDA vs CPU {k}: max scaled diff {diff} > {CPU_GPU_TOL}")
    print(f"CUDA vs CPU (bs=2, K=4, 20 Heun steps): max |a-b|/(1+|b|) = {worst:.3e} "
          f"<= {CPU_GPU_TOL}", flush=True)
    return worst


def fused_geometry_path(dev):
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
          f"FPS + ball query {_ms(profiled[False])}; {card_line()}", flush=True)
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


def tracking_path(dev, card, nocs, agents, frozen_arm=False, compute_dtype="float32"):
    """Phase 10: ``evaluation_tracking.main_tracking`` (T0=0.15) at full width
    on the phase-9 tree, the launch counts and the pooled poses read around
    each frame; then one frame profiled.  ``main_tracking`` freezes its
    agents: phase 10 is the eager arm, with ``freeze`` turned into a no-op on
    the two agents for the run; phase 12 runs the frozen arm
    (``frozen_arm``), as a user calls it, and phase 13 the same with
    ``--compute_dtype bfloat16`` agents.  Returns the summary, the pooled
    poses of every frame and the metrics."""
    from genpose_tpu_torch.data.synthetic import make_synthetic_mrcnn_results
    from genpose_tpu_torch.ops import ball_query_cuda, fps_cuda
    from genpose_tpu_torch.runners import evaluation_single as ev
    from genpose_tpu_torch.runners import evaluation_tracking as et
    from genpose_tpu_torch.training import frozen
    from genpose_tpu_torch.utils.tracking import add_noise_to_RT, srt_to_pose9d

    arm = ("frozen" if frozen_arm else "eager") + (
        "" if compute_dtype == "float32" else f" {compute_dtype}")
    result_dir = str(OUT_DIR / "eval" / f"tracking_{arm.replace(' ', '_')}")
    make_synthetic_mrcnn_results(nocs, result_dir, "real_test", tracking=True)
    cfg = eval_config(nocs, result_dir, T0=TRACK_T0, compute_dtype=compute_dtype)
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
          f"{cfg.sampling_steps} Heun steps): {len(frames) / wall:.3f} frames/s ({wall:.3f} s; "
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


def _graph_stats(*agents):
    """Warm-up and capture (+ instantiate) seconds and graph count of each
    frozen program of the agents."""
    out = {}
    for a in agents:
        programs = a._frozen.programs if a._frozen is not None else {}
        for key, prog in programs.items():
            out[f"{a.mode} {key[0]} {key[1]}x{key[2]}"] = {
                "warmup_s": prog.warmup_s, "capture_s": prog.capture_s,
                "graphs": len(prog.segments)}
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
        graphs = _graph_stats(pipe.score_agent, pipe.energy_agent)
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
    graphs = _graph_stats(score, energy)
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
    graphs = _graph_stats(*agents)
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
        graphs = _graph_stats(pipe.score_agent, pipe.energy_agent)

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
    score.freeze()
    energy.freeze()
    secs, launches, dispatches = eval_stages_2_3(cfg, score, energy, ctx["seg"], out_dir, chunks,
                                                 "bf16 frozen")
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
                           "graphs": _graph_stats(score, energy)},
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from genpose_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    print(f"built {lib.relative_to(_build.PKG_DIR.parent)} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    fps_rows, bq_rows, fused_rows, max_err = check_kernels(dev)
    for row in fps_rows + bq_rows + fused_rows:
        print(json.dumps(row), flush=True)
    fused_launches, chain_times, fused_profiled = fused_geometry_path(dev)

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
        phase 13 and of the checkpoint and sampler paths of phase 14."""
        fz = frozen_arms
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
                "likelihood_launches": phase14["cpu_gpu"]["likelihood"]["launches"][k]}

    kernels = [
        summary("fps", "genpose_tpu_torch/csrc/fps.cu", "genpose_tpu/ops/fps_pallas.py:75",
                fps_rows, fps_launches, profiled_device_ms=profiled["ode"].get("fps"),
                path="serving request", training_score_run_launches=train_launches["fps"],
                **path_launches("fps")),
        summary("ball_query", "genpose_tpu_torch/csrc/ball_query.cu",
                "genpose_tpu/ops/ball_query_pallas.py:84", bq_rows, bq_launches,
                profiled_device_ms=profiled["ode"].get("ball_query"),
                path="serving request",
                training_score_run_launches=train_launches["ball_query"],
                **path_launches("ball_query")),
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
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
