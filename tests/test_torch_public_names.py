"""The last public names of the JAX package the port lacked, each against
its JAX counterpart on the same seeded inputs:

- ``ops/pose.py::rot_diff_rad`` / ``rot_diff_degree`` (whole rotation, and
  about one column with and without the flip), within 1e-6;
- ``data/augment.py::get_rotation``, within 1e-6;
- ``utils/logging.py::setup_logger`` (the same lines written; a second
  setup replaces the handlers) and ``merge_results`` (the same arrays);
- ``models/layers.py::MLP``: the flax module's parameters carried by
  ``utils/weights.py::from_jax_variables``, the output within 1e-6;
- ``utils/benchmarking.py::flops_of`` against ``flops_from_cost`` of the
  compiled JAX function: a Dense and a batched matmul, 2 M N K each;
- ``eval/metrics.py::compute_RT_overlaps``, the same numbers.
"""

import logging
import re

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose_tpu.data import augment as jaug
from genpose_tpu.eval import metrics as jmetrics
from genpose_tpu.models import layers as jlayers
from genpose_tpu.ops import pose as jpose
from genpose_tpu.utils import benchmarking as jbench
from genpose_tpu.utils import logging as jlog
from genpose_tpu_torch.data import augment as taug
from genpose_tpu_torch.eval import metrics as tmetrics
from genpose_tpu_torch.models import layers as tlayers
from genpose_tpu_torch.ops import pose as tpose
from genpose_tpu_torch.utils import benchmarking as tbench
from genpose_tpu_torch.utils import logging as tlog
from genpose_tpu_torch.utils.weights import from_jax_variables

SYNSET = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]


def _rotations(seed: int, n: int) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.array(jpose.quat_wxyz_to_matrix(jnp.asarray(q, jnp.float32)))


@pytest.mark.parametrize("axis, flip", [(None, False), ("x", False), ("y", True), ("z", True)],
                         ids=["whole", "x", "y_flip", "z_flip"])
def test_rot_diff(axis, flip):
    r1, r2 = _rotations(0, 64), _rotations(1, 64)
    # identical pairs, where arccos meets its clamp
    r2[:4] = r1[:4]
    for fn in ("rot_diff_rad", "rot_diff_degree"):
        want = np.asarray(getattr(jpose, fn)(jnp.asarray(r1), jnp.asarray(r2), axis, flip))
        got = getattr(tpose, fn)(torch.from_numpy(r1), torch.from_numpy(r2), axis, flip)
        assert got.dtype == torch.float32 and got.shape == (64,)
        scale = 180.0 / np.pi if fn == "rot_diff_degree" else 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (15.0, -7.5, 30.0), (-179.0, 90.0, 45.5),
                                    (1e-3, 359.0, -60.0)])
def test_get_rotation(angles):
    want = np.asarray(jaug.get_rotation(*angles))
    got = taug.get_rotation(*angles)
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_setup_logger_writes_what_jax_writes(tmp_path):
    def run(module, name):
        path = tmp_path / f"{name}.txt"
        for i in range(2):  # a second setup must not double-write
            logger = module.setup_logger(name, str(path))
            logger.info(f"line {i}")
            logger.debug("below the level")
        n_handlers = len(logger.handlers)
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        text = path.read_text()
        return re.sub(r"^\S+ \S+ : ", "T : ", text, flags=re.M), n_handlers

    got, want = run(tlog, "port_logger"), run(jlog, "jax_logger")
    assert got == want and got == ("T : line 0\nT : line 1\n", 2)
    assert logging.getLogger("port_logger").level == logging.INFO


def test_merge_results_equals_jax():
    rng = np.random.default_rng(4)

    def batch(n):
        return {"pred_pose": rng.random((n, 4, 4)), "gt_pose": rng.random((n, 4, 4)),
                "cls_id": rng.integers(0, 6, n), "handle_visibility": rng.integers(0, 2, n),
                "extra": rng.random(n)}

    a, b = batch(3), batch(5)
    assert tlog.merge_results({}, a) is a and jlog.merge_results({}, a) is a
    got, want = tlog.merge_results(a, b), jlog.merge_results(a, b)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_mlp_carries_flax_params_and_agrees():
    features, x = (32, 16, 8), np.random.default_rng(5).normal(size=(6, 12)).astype(np.float32)
    mod = jlayers.MLP(features=features)
    variables = mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    port = tlayers.MLP(12, features)
    port.load_state_dict(from_jax_variables(variables["params"], {}), strict=True)
    assert [n for n, _ in port.named_children()] == ["dense_0", "dense_1", "dense_2"]
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 8) and (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _xla_flops(fn, *args) -> float:
    return jbench.flops_from_cost(jax.jit(fn).lower(*args).compile().cost_analysis())


@pytest.mark.parametrize("m, k, n", [(8, 12, 16), (64, 128, 256)])
def test_flops_of_equals_flops_from_cost(m, k, n):
    """A Dense without bias and a batched matmul: 2 M N K on both sides.
    (XLA also counts a bias add's M N, which ``flops_of``, counting matrix
    products only, leaves out.)"""
    dense = jnn.Dense(n, use_bias=False)
    params = dense.init(jax.random.PRNGKey(0), jnp.ones((m, k)))
    xla = _xla_flops(dense.apply, params, jnp.ones((m, k)))
    port = tbench.flops_of(tlayers.Dense(k, n, bias=False), torch.ones(m, k))
    assert port == xla == 2 * m * n * k
    b = 3
    xla = _xla_flops(jnp.matmul, jnp.ones((b, m, k)), jnp.ones((b, k, n)))
    port = tbench.flops_of(torch.matmul, torch.ones(b, m, k), torch.ones(b, k, n))
    assert port == xla == 2 * b * m * n * k


def test_compute_RT_overlaps_equals_jax():
    rng = np.random.default_rng(6)
    n = 12
    rot_gt, rot_pred = _rotations(2, n).astype(np.float64), _rotations(3, n).astype(np.float64)
    rot_pred[:3] = rot_gt[:3]  # exact matches: zero errors
    gt, pred = np.tile(np.eye(4), (n, 1, 1)), np.tile(np.eye(4), (n, 1, 1))
    scale = rng.uniform(0.05, 0.3, (n, 1, 1))
    gt[:, :3, :3], pred[:, :3, :3] = rot_gt * scale, rot_pred * scale
    gt[:, :3, 3], pred[:, :3, 3] = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    class_ids = np.arange(n) % 6 + 1  # every class, the symmetric ones and the mug
    visible = rng.integers(0, 2, n)
    got = tmetrics.compute_RT_overlaps(class_ids, gt, pred, visible, SYNSET)
    want = jmetrics.compute_RT_overlaps(class_ids, gt, pred, visible, SYNSET)
    assert got.shape == (n, 2) and np.array_equal(got, want)
