"""The traffic and the weights repeat exactly for a seed and differ between
seeds, seeds beyond 32 bits included."""

import numpy as np
import pytest
import torch

from harness import common, traffic as gen
from reference import genpose_ref as ref

CPU = torch.device("cpu")
BIG = 2**31 + 12345
SEEDS = [(BIG, BIG + 1), (7, 8)]
SERVE = {**common.load("traffic", "eval_b256"), "batch": 3, "points": 64}
TRAIN = {**common.load("traffic", "train_b192"), "batch": 4, "points": 64, "pool": 2}


def batches(seed):
    return np.concatenate([v.reshape(-1).astype(np.float64)
                           for b in gen.train_batches(TRAIN, seed, CPU) for v in b.values()])


def weights(seed):
    spec = ref.param_spec(common.load("configs", "genpose_light")["encoder_stages"])
    return torch.cat([v.reshape(-1) for v in common.make_weights(spec, CPU, seed).values()])


MAKERS = {
    "request_clouds": lambda s: gen.request_clouds(SERVE, s, 5, CPU).numpy().reshape(-1),
    "augment_draws": lambda s: torch.cat([v.reshape(-1) for v in gen.augment_draws(
        common.generator(CPU, s), TRAIN, CPU).values()]).numpy(),
    "train_batches": batches,
    "dsm_draws": lambda s: torch.cat([x.reshape(-1) for x in gen.dsm_draws(
        common.generator(CPU, s), 2, 4, CPU)]).numpy(),
    "weights": lambda s: weights(s).numpy(),
}


@pytest.mark.parametrize("what", sorted(MAKERS))
@pytest.mark.parametrize("seed,other", SEEDS)
def test_same_seed_same_inputs_other_seed_other_inputs(what, seed, other):
    a, b, c = MAKERS[what](seed), MAKERS[what](seed), MAKERS[what](other)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_clouds_are_object_sized_and_in_front_of_the_camera():
    pts = gen.request_clouds(SERVE, BIG, 0, CPU)
    centred = pts - pts.mean(1, keepdim=True)
    assert float(centred.norm(dim=-1).max()) < 0.17
    assert bool((pts.mean(1)[:, 2] > 0.75).all())


def test_training_objects_carry_what_the_loader_hands_over():
    """Each object's box, model points, FS-Net scale and mean shape agree
    with its category and scale, and the loader's draws lie in their
    ranges."""
    b = gen.train_batches(TRAIN, BIG, CPU)[0]
    cats = TRAIN["categories"]
    mean = np.array([cats[c]["mean_shape_mm"] for c in b["cat_id"]]) / 1000.0
    np.testing.assert_allclose(b["mean_shape"], mean, rtol=1e-6)
    extent = b["model_point"].max(1) - b["model_point"].min(1)
    np.testing.assert_allclose(b["fsnet_scale"] + b["mean_shape"],
                               extent * b["nocs_scale"][:, None], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(extent, axis=1), 1.0, rtol=1e-5)
    R, Ra = b["rotation"], b["aug_rt_R"]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(Ra @ Ra.transpose(0, 2, 1), np.broadcast_to(np.eye(3), Ra.shape),
                               atol=1e-5)
    obs = (b["nocs_scale"][:, None, None] * b["model_point"]) @ R.transpose(0, 2, 1)
    np.testing.assert_allclose(obs + b["translation"][:, None], b["pcl_in"], atol=1e-6)
    ld = TRAIN["loader_draws"]
    assert ((b["aug_bb"] >= ld["box_scale"][0]) & (b["aug_bb"] <= ld["box_scale"][1])).all()
    assert (np.abs(b["aug_rt_t"]) <= ld["shift_m"]).all()
    angle = np.degrees(np.arccos(np.clip((np.trace(Ra, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert angle.max() <= np.sqrt(3) * ld["angle_deg"] + 1e-3


def test_seed_streams_are_distinct_and_fit_63_bits():
    s = {common.seed_of(BIG, *p) for p in [(0, 0), (0, 1), (1, 0), (1, -1), (7, 3)]}
    assert len(s) == 5 and all(0 <= v < 2**63 for v in s)
