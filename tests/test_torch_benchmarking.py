"""genpose_tpu_torch/utils/benchmarking.py on the CPU.

``carrier`` is float32 whatever its leaves' dtype, as the JAX helper's;
``flops_of`` counts one ``Dense`` as 2 M N K; the chained timers return a
positive time per call on the host clock; ``derandomize_`` moves every
parameter as ``utils/weights.py::perturb_`` does; ``peak_flops`` has no
number without a card; ``card_line`` is the first card's line of
``nvidia-smi`` and raises where there is none.
"""

import subprocess
import time

import pytest
import torch

from genpose_tpu_torch.config import Config
from genpose_tpu_torch.models.layers import Dense
from genpose_tpu_torch.training.agent import PoseAgent
from genpose_tpu_torch.utils import benchmarking as bm
from genpose_tpu_torch.utils.weights import perturb_


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_carrier_is_float32_for_any_leaves(dtype):
    leaves = {"a": torch.ones(3, 4, dtype=dtype), "b": [torch.full((2,), 2, dtype=dtype)],
              "c": (torch.arange(3, dtype=torch.int32),)}
    c = bm.carrier(leaves)
    assert c.dtype == torch.float32 and c.shape == ()
    assert float(c) == 12 + 4 + 3


@pytest.mark.parametrize("m,k,n", [(8, 16, 32), (5, 1024, 256)])
def test_flops_of_a_dense_is_2mnk(m, k, n):
    layer = Dense(k, n)
    assert bm.flops_of(layer, torch.randn(m, k)) == 2 * m * n * k


def _sleepy(x, generator):
    time.sleep(0.002)  # a call the host clock can see
    return x * 2 + torch.rand(x.shape, generator=generator)


def test_time_chain_marginal_is_positive_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    per_iter, envelope = bm.time_chain_marginal(_sleepy, torch.zeros(4), g, iters=4)
    assert 0.002 <= per_iter < 0.5 and envelope >= 0.0
    assert 0.002 <= bm.time_chain(_sleepy, torch.zeros(4), g, iters=3) < 0.5


def test_chain_feeds_each_output_into_the_next_input():
    """Call i's input is x + 1e-12 * carrier(call i-1's output)."""
    seen = []

    def fn(x, generator):
        seen.append(x.clone())
        return torch.full_like(x, float(len(seen)))

    bm._chain(fn, torch.zeros(2, dtype=torch.float64), None, 3)
    want = torch.tensor([[0.0, 0.0], [2e-12, 2e-12], [4e-12, 4e-12]], dtype=torch.float64)
    torch.testing.assert_close(torch.stack(seen), want, rtol=1e-6, atol=0)


def test_derandomize_moves_every_parameter_as_perturb():
    cfg = Config(num_points=32)
    a, b = PoseAgent(cfg, "score", device="cpu"), PoseAgent(cfg, "score", device="cpu")
    bm.derandomize_(a, seed=5)
    perturb_(b.model, seed=5)
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    assert a.state.ema.shadow is None


def test_peak_flops_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bm.peak_flops(torch.bfloat16) is None
    assert bm.PEAK_FLOPS["H100"][torch.bfloat16] == 989e12
    assert bm.PEAK_FLOPS["H100"][torch.float32] == 67e12


def test_card_line_is_the_first_cards_line(monkeypatch):
    seen = []

    def run(cmd, **kw):
        seen.append((cmd, kw))
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n")

    monkeypatch.setattr(bm.subprocess, "run", run)
    assert bm.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen[0][0] == ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    assert seen[0][1]["check"]

    def missing(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bm.subprocess, "run", missing)
    with pytest.raises(FileNotFoundError):
        bm.card_line()
