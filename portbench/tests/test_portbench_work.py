"""The work counted from widths and shapes equals what FlopCounterMode
counts over the reference at small shapes, so a share of a peak or of a
roofline cannot pass 100% by counting; the geometry's count is bounded by
a full scan."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import cellrun, common, traffic as gen, work
from reference import genpose_ref as ref

CPU = torch.device("cpu")
CONFIGS = ["genpose_light", "genpose_full"]


def counted(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_forward_count(name):
    config = common.load("configs", name)
    r, stages = ref.Ref(config), config["encoder_stages"]
    w = common.make_weights(ref.param_spec(stages), CPU, 3)
    pts = torch.randn(2, 96, 3) * 0.05
    geo = r.geometry(pts)
    assert counted(lambda: r.encode(w, pts, geo)) == 2 * work.encoder_ops(stages, 96)


@pytest.mark.parametrize("name", CONFIGS)
def test_request_count(name):
    config = common.load("configs", name)
    r, stages = ref.Ref(config), config["encoder_stages"]
    ws, we = common.pair_weights(config, CPU, 4)
    B, K, N, steps = 2, 3, 64, 5
    pts = gen.request_clouds({**common.load("traffic", "eval_b256"), "batch": B, "points": N},
                             4, 0, CPU)
    z = torch.randn(B * K, 9)

    def request():
        hyp, geo, zm, center = r.sample(ws, pts, z, K, steps, 0.55)
        r.energies(we, zm, center, hyp, geo)

    assert counted(request) == work.serve_ops(stages, B, K, N, steps)


@pytest.mark.parametrize("name", CONFIGS)
def test_training_step_count(name):
    config = common.load("configs", name)
    r, stages = ref.Ref(config), config["encoder_stages"]
    w0 = common.make_weights(ref.param_spec(stages), CPU, 5)
    B, R, N = 3, 2, 64
    zm = torch.randn(B, N, 3) * 0.05
    gt = torch.randn(B, 9)
    t, z = gen.dsm_draws(common.generator(CPU, 5), R, B, CPU)
    names = [k for k in w0 if not ref.is_buffer(k)]

    def step():
        leaves = {k: w0[k].clone().requires_grad_(True) for k in names}
        with torch.no_grad():
            geo = r.geometry(zm)
        loss = r.dsm_loss({**w0, **leaves}, zm, gt, t, z, geo)
        torch.autograd.grad(loss, [leaves[k] for k in names])

    assert counted(step) == work.train_ops(stages, B, R, N)
    with torch.no_grad():
        geo = r.geometry(zm)
        assert (counted(lambda: r.dsm_loss(w0, zm, gt, t, z, geo))
                == work.dsm_forward_ops(stages, B, R, N))


@pytest.mark.parametrize("name", CONFIGS)
def test_geometry_count_is_at_most_a_full_scan(name):
    stages = common.load("configs", name)["encoder_stages"]
    xyz = gen.request_clouds({**common.load("traffic", "eval_b256"), "batch": 2,
                              "points": 256}, 6, 0, CPU)
    xyz = xyz - xyz.mean(1, keepdim=True)
    ops, nbytes = work.geometry_work(stages, xyz)
    full = 0
    n = 256
    for npoint, radii in zip(stages["NPOINTS"], stages["RADIUS"]):
        if npoint is None:
            break
        full += 2 * (npoint - 1) * n * 10 + 2 * npoint * n * (8 + len(radii))
        n = npoint
    assert 0 < ops <= full and nbytes > 0


def test_shares_stay_at_or_under_100_on_the_counted_work():
    peak = common.PEAKS["H100"]
    ops = 1e12
    view = cellrun.RunView({}, units=10, window_s=10 * ops / peak["float32_ops_per_s"],
                           ops_per_unit=ops, peak=peak,
                           summary={"busy_s": 1.0, "window_s": 1.0,
                                    "kernels": {"void fps_kernel<8>": 2e-3}},
                           geometry_least_s=2e-3, patterns={"geometry": ["fps_kernel"]})
    assert view.mfu_pct() == pytest.approx(100.0)
    assert view.roofline_pct("geometry") == pytest.approx(100.0)
    assert view.idle_pct() == 0.0
    view.summary["kernels"] = {}
    assert view.roofline_pct("geometry") is None   # nothing to read: no metric, never 0
