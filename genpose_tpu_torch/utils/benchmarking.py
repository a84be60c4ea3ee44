"""Benchmarking helpers (counterpart of ``genpose_tpu/utils/benchmarking.py``).

- ``PEAK_FLOPS`` / ``peak_flops``: the card's peak rate per dtype, for a
  roofline share;
- ``derandomize_``: non-zero heads for timing runs (the seeded init has
  zero tail outputs);
- ``carrier`` / ``time_chain`` / ``time_chain_marginal``: a chain of calls
  serialised by a data dependence and timed as one, and its marginal
  per-call time from chains of n and 2n calls;
- ``flops_of``: the matrix-product operations of one call;
- ``card_line``: the card's name and power limit, to print beside a time.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from genpose_tpu_torch.utils.weights import perturb_

# Dense (no sparsity) peak rates per card, keyed by a substring of
# ``torch.cuda.get_device_name()``.  H100 SXM5: 989 TFLOPS bfloat16 on the
# tensor cores and 67 TFLOPS float32 outside them (NVIDIA H100 Tensor Core
# GPU datasheet, SXM5 column).
PEAK_FLOPS = {"H100": {torch.bfloat16: 989e12, torch.float32: 67e12}}


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def peak_flops(dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """The peak operations/s of card 0 for ``dtype``; None without a card or
    for a card or dtype the table does not hold."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    for key, rates in PEAK_FLOPS.items():
        if key in name:
            return rates.get(dtype)
    return None


@torch.no_grad()
def derandomize_(agent, scale: float = 0.01, seed: int = 42):
    """Add ``scale * N(0, 1)`` to every parameter of ``agent`` (JAX
    ``derandomize_state``, through ``utils/weights.py::perturb_``), so the
    zero-initialised tail outputs do real work; an EMA shadow becomes a copy
    of the new parameters."""
    perturb_(agent.model, seed=seed, scale=scale)
    if agent.state.ema.shadow is not None:
        agent.state.ema.shadow = {k: p.detach().clone()
                                  for k, p in agent.model.named_parameters()}
    return agent


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def carrier(leaves) -> torch.Tensor:
    """A float32 scalar that depends on every tensor in ``leaves`` (a tensor
    or a nest of dicts, lists and tuples), whatever their dtypes: the link
    of ``time_chain``'s data dependence."""
    sums = [t.float().sum() for t in _leaves(leaves)]
    return torch.stack(sums).sum()


def flops_of(fn: Callable, *args, **kwargs) -> int:
    """Operations of one ``fn(*args, **kwargs)`` as PyTorch's
    ``FlopCounterMode`` counts them: matrix products (mm, addmm, bmm, the
    matmuls and einsums they lower to; convolutions, of which the port has
    none) at 2 per multiply-add.  Elementwise work, reductions, gathers and
    the custom kernels are not counted (the counterpart of XLA's
    ``cost_analysis`` flops, which counts more)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def _chain(fn: Callable, x: torch.Tensor, generator, n: int):
    """``n`` calls of ``fn(x_i, generator)``, each input bumped by 1e-12
    times the previous output's carrier, so the calls run in order and none
    can be skipped."""
    c = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(n):
        c = carrier(fn(x + (1e-12 * c).to(x.dtype), generator))
    return c


def _timed(fn: Callable, x: torch.Tensor, generator, n: int) -> float:
    """Seconds of one chain of ``n`` calls: between two CUDA events on the
    card, on the host clock on the CPU."""
    if x.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        start.record()
        _chain(fn, x, generator, n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(_chain(fn, x, generator, n))
    return time.perf_counter() - t0


def time_chain(fn: Callable, x: torch.Tensor, generator, iters: int) -> float:
    """Seconds per call of a chain of ``iters`` calls (after one warm-up
    chain): the chain's fixed cost is spread over its calls."""
    _timed(fn, x, generator, 1)
    return _timed(fn, x, generator, iters) / iters


def time_chain_marginal(fn: Callable, x: torch.Tensor, generator,
                        iters: int) -> Tuple[float, float]:
    """(per-call seconds, envelope seconds): chains of ``iters`` and
    ``2 * iters`` calls, run interleaved three times each after a warm-up,
    each length's fastest kept; the per-call time is their difference over
    ``iters`` and the envelope what the shorter chain takes beyond its
    calls.  On the card the envelope is the chain's fixed cost between its
    two events (the wait for the first launch and any host work the
    chain's length does not scale), on the CPU the host's per-chain cost;
    the difference cancels it, so short calls are timed honestly."""
    _timed(fn, x, generator, 1)
    t1, t2 = [], []
    for _ in range(3):
        t1.append(_timed(fn, x, generator, iters))
        t2.append(_timed(fn, x, generator, 2 * iters))
    per_iter = (min(t2) - min(t1)) / iters
    return per_iter, max(min(t1) - per_iter * iters, 0.0)
