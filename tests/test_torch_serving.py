"""genpose_tpu_torch InferencePipeline against the JAX InferencePipeline.

Same weights on both sides (the score agent's EMA shadow for sampling, the
energy agent's live params for ranking, as the JAX pipeline reads them) and
the same prior rows (each score agent's SDE prior pinned to ``noise``).
Sizes follow ``tests/test_serving.py``: 64 points, batch 2, K=3, 3 Heun
steps; and the same under the adaptive RK45 sampler, where the padded rows
share the step size of the real ones, as in the JAX pipeline.

Tolerance: rtol = atol = 1e-4.  The two pipelines run the same float32
chain on the CPU; per-op differences (GEMM summation order, ~1e-7) pass
through the encoder, the sampler and the 4x4 eigen-solve of the pooling.
"""

import jax
import numpy as np
import pytest

from genpose_tpu.config import Config
from genpose_tpu.runners.serving import InferencePipeline as JaxPipeline
from genpose_tpu_torch.config import Config as TorchConfig
from genpose_tpu_torch.runners.serving import InferencePipeline
from _torch_parity import derandomize_agent, pin_jax_prior, pin_port_prior

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(num_points=64, batch_size=2, eval_repeat_num=3, sampling_steps=3, T0=0.55)


def make_pipes(sampler="ode"):
    """A JAX pipeline and the port's on the CPU with the same weights and prior rows."""
    cfg = dict(CFG, sampler_mode=(sampler,))
    jp = JaxPipeline(Config(**cfg))
    derandomize_agent(jp.score_agent, 1)
    derandomize_agent(jp.energy_agent, 2)
    noise = np.random.default_rng(0).normal(size=(2 * 3, 9)).astype(np.float32)
    pin_jax_prior(jp.score_agent, noise)

    tp = InferencePipeline(TorchConfig(**cfg), device="cpu")
    ss, es = jp.score_agent.state, jp.energy_agent.state
    tp.score_agent.load_jax(jax.device_get(ss.ema.shadow), jax.device_get(ss.batch_stats))
    tp.energy_agent.load_jax(jax.device_get(es.params), jax.device_get(es.batch_stats))
    pin_port_prior(tp.score_agent, noise)
    return jp, tp


@pytest.fixture(scope="module")
def pipes():
    return make_pipes("ode")


@pytest.fixture(scope="module")
def rk45_pipes():
    return make_pipes("ode_adaptive")


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 64, 3)) * 0.1 + rng.normal(size=(n, 1, 3))
    return pts.astype(np.float32)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
    for k in ("best_pose", "sorted_hypotheses", "energy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # the pooled quaternion is an eigenvector: compare up to sign
    q, wq = got["pred_pose"][:, :4], want["pred_pose"][:, :4]
    sign = np.sign(np.sum(q * wq, axis=1, keepdims=True))
    np.testing.assert_allclose(q * sign, wq, err_msg="pred_pose q", **TOL)
    np.testing.assert_allclose(got["pred_pose"][:, 4:], want["pred_pose"][:, 4:],
                               err_msg="pred_pose t", **TOL)


@pytest.mark.parametrize("sampler,n", [
    ("ode", 2), ("ode", 1), ("ode", 5), ("ode_adaptive", 2), ("ode_adaptive", 1),
    ("ode_adaptive", 5)], ids=["full_batch", "padded", "chunked", "rk45_full_batch",
                               "rk45_padded", "rk45_chunked"])
def test_predict_matches_jax(request, sampler, n):
    jp, tp = request.getfixturevalue("pipes" if sampler == "ode" else "rk45_pipes")
    pts = _cloud(n, seed=n)
    want = jp.predict(pts, key=jax.random.PRNGKey(0))
    got = tp.predict(pts)
    assert got["pred_pose"].shape == (n, 7)
    assert got["sorted_hypotheses"].shape == (n, 3, 9)
    _assert_same(got, want)
    np.testing.assert_allclose(np.linalg.norm(got["pred_pose"][:, :4], axis=1), 1.0,
                               atol=1e-5)


def test_padding_rows_do_not_touch_real_rows(pipes):
    """The same row alone (padded) and beside another row: same result."""
    _, tp = pipes
    pts = _cloud(2, seed=9)
    alone = tp.predict(pts[:1])
    paired = tp.predict(pts)
    for k in alone:
        np.testing.assert_array_equal(alone[k], paired[k][:1])


def test_empty_request(pipes):
    _, tp = pipes
    out = tp.predict(np.zeros((0, 64, 3), np.float32))
    assert out["pred_pose"].shape == (0, 7)
    assert out["best_pose"].shape == (0, 7)
    assert out["sorted_hypotheses"].shape == (0, 3, 9)
    assert out["energy"].shape == (0, 3, 2)


def test_adaptive_sampler_pipeline_runs(rk45_pipes):
    """After ``warmup``, a padded and chunked RK45 request equals the JAX pipeline's."""
    jp, tp = rk45_pipes
    pts = _cloud(3, seed=4)
    want = jp.warmup().predict(pts, key=jax.random.PRNGKey(0))
    got = tp.warmup().predict(pts)
    assert got["pred_pose"].shape == (3, 7)
    _assert_same(got, want)
