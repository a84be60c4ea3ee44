"""Traffic of kind ``serve``: one client sends requests of ``batch`` object
clouds back to back (a closed loop) through the frozen
``InferencePipeline.predict``.  End to end: ``poses_per_s``, every pose of
the window's requests over the window's time."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import check, common, traffic as gen, work
from reference import genpose_ref as ref


class Driver:
    def __init__(self, config, traffic, device, seed, spans):
        self.config, self.traffic, self.device, self.seed = config, traffic, device, seed
        self.spans = spans
        self.K = traffic["hypotheses"]
        self.keep = max(1, int(traffic["keep_ratio"] * self.K))
        self.pooled = []

    def setup(self) -> None:
        from genpose_tpu_torch.runners.serving import InferencePipeline

        tr = self.traffic
        cfg = common.port_config(self.config, batch_size=tr["batch"], eval_repeat_num=self.K,
                                 sampling_steps=tr["steps"], T0=tr["T0"],
                                 sampler_mode=(tr["sampler"],), ratio=tr["keep_ratio"])
        self.pipe = InferencePipeline(cfg, device=self.device)
        w_score, w_energy = common.pair_weights(self.config, self.device, self.seed)
        common.load_weights(self.pipe.score_agent, w_score)
        common.load_weights(self.pipe.energy_agent, w_energy)
        self.pipe.freeze().warmup()

    def warm(self, i: int) -> None:
        """A request before the window (real clouds, not checked)."""
        self.request(-1 - i)

    def start(self) -> None:
        """From here on the program's outputs are kept and its calls spanned."""
        self.taps = [common.Tap(self.pipe.score_agent, "sample"),
                     common.Tap(self.pipe.energy_agent, "get_energy")]
        self.spans.wrap(self.pipe.score_agent, "sample", "sample")
        self.spans.wrap(self.pipe.energy_agent, "get_energy", "get_energy")

    def prior(self, i: int) -> torch.Generator:
        return common.generator(self.device, common.seed_of(self.seed, 7, i))

    def request(self, i: int):
        """Request i's clouds arrive on the host; then, timed, the pipeline
        serves them.  Returns (its output, seconds)."""
        pts = gen.request_clouds(self.traffic, self.seed, i, self.device).cpu().numpy()
        g = self.prior(i)
        t0 = time.perf_counter()
        with self.spans.span("request"):
            out = self.pipe.predict(pts, generator=g)
        return out, time.perf_counter() - t0

    def unit(self, i: int) -> float:
        out, seconds = self.request(i)
        self.pooled.append(out["pred_pose"])
        return seconds

    def end_to_end(self, units: int, window_s: float, latencies) -> dict:
        return {"poses_per_s": units * self.traffic["batch"] / window_s}

    def ops_per_unit(self) -> int:
        tr = self.traffic
        return work.serve_ops(self.config["encoder_stages"], tr["batch"], self.K, tr["points"],
                              tr["steps"])

    def profiled(self, first: int, n: int) -> None:
        for i in range(first, first + n):
            self.request(i)
        self.profiled_range = (first, n)

    def geometry_clouds(self):
        first, n = self.profiled_range
        for i in range(first, first + n):
            pts = gen.request_clouds(self.traffic, self.seed, i, self.device)
            yield pts - pts.mean(1, keepdim=True)

    def close(self, units: int) -> None:
        """Keep the checked requests' outputs, free the program."""
        rng = np.random.default_rng(common.seed_of(self.seed, 9))
        n = min(self.traffic["check_units"], units)
        self.checked = sorted(rng.choice(units, size=n, replace=False).tolist())
        hyps, energies = self.taps[0].outs, self.taps[1].outs
        self.outs = {i: (hyps[i].cpu(), energies[i].cpu(), self.pooled[i]) for i in self.checked}
        for tap in self.taps:
            tap.close()
        del self.pipe, self.taps
        self.pooled.clear()

    def check(self) -> dict:
        r = ref.Ref(self.config)
        w_score, w_energy = common.pair_weights(self.config, self.device, self.seed)
        tr, dev = self.traffic, self.device
        nums = []
        for i in self.checked:
            hyp, energy, pooled = (x.to(dev) if torch.is_tensor(x) else x
                                   for x in self.outs[i])
            pooled = torch.as_tensor(pooled, device=dev)
            pts = gen.request_clouds(tr, self.seed, i, dev)
            z = torch.randn((tr["batch"] * self.K, 9), generator=self.prior(i), device=dev)
            hyp_ref, geo, zm, center = r.sample(w_score, pts, z, self.K, tr["steps"], tr["T0"])
            e_ref = r.energies(w_energy, zm, center, hyp, geo)
            nums.append(check.serve_numbers(hyp, energy, pooled[:, :4], pooled[:, 4:], self.keep,
                                            hyp_ref, e_ref))
        return check.worst(nums)



def control(config, traffic, device, seed, n):
    """Requests 0..n-1 of a run served by the TF32 reference in the
    program's place (its hypotheses, energies and pooled poses), and the
    faults planted in the float32 reference, each judged against the
    float32 reference."""
    r32, r19 = ref.Ref(config), ref.Ref(config, tf32=True)
    ws, we = common.pair_weights(config, device, seed)
    K = traffic["hypotheses"]
    keep = max(1, int(traffic["keep_ratio"] * K))
    nums = []
    for i in range(n):
        pts = gen.request_clouds(traffic, seed, i, device)
        z = torch.randn((traffic["batch"] * K, 9), device=device,
                        generator=common.generator(device, common.seed_of(seed, 7, i)))
        hyp_p, geo, zm, center = r19.sample(ws, pts, z, K, traffic["steps"], traffic["T0"])
        e_p = r19.energies(we, zm, center, hyp_p, geo)
        q_p, t_p = check.pool(r19, hyp_p, e_p, keep)
        hyp_ref, geo, zm, center = r32.sample(ws, pts, z, K, traffic["steps"], traffic["T0"])
        nums.append({"control": check.serve_numbers(hyp_p, e_p, q_p, t_p, keep, hyp_ref,
                                                    r32.energies(we, zm, center, hyp_p, geo)),
                     **faults(r32, we, zm, center, geo, hyp_ref, keep)})
    return {k: check.worst([x[k] for x in nums]) for k in nums[0]}


def faults(r32, we, zm, center, geo, hyp_ref, keep):
    """The faults' numbers against the float32 reference's own hypotheses
    ``hyp_ref`` [B, K, 9] (B >= 2): "half of the batch left out" (the second
    half of the objects given the first half's hypotheses, energies and
    poses recomputed from them) and "an answer altered where it is
    produced" (the first object's pooled pose replaced by its best-energy
    hypothesis, as if pooling were skipped)."""
    B = hyp_ref.shape[0]
    out = {}
    half = hyp_ref.clone()
    half[B - B // 2:] = hyp_ref[:B // 2]
    e_half = r32.energies(we, zm, center, half, geo)
    q, t = check.pool(r32, half, e_half, keep)
    out["half_batch"] = check.serve_numbers(half, e_half, q, t, keep, hyp_ref, e_half)
    e_ref = r32.energies(we, zm, center, hyp_ref, geo)
    q, t = check.pool(r32, hyp_ref, e_ref, keep)
    best = check.order(e_ref)[0, 0, 0]
    rot = ref.rot6d_to_matrix(hyp_ref[0, best, :6])
    q, t = q.clone(), t.clone()
    q[0], t[0] = ref.matrix_to_quat(rot), hyp_ref[0, best, 6:]
    out["answer_altered"] = check.serve_numbers(hyp_ref, e_ref, q, t, keep, hyp_ref, e_ref)
    return out
