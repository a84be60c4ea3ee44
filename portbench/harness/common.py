"""What every cell shares: the files found by name, the device, the weights,
the spans, and the result line.

A cell is ``cells/<workload>.json`` (its configuration, its traffic and
the limits of its compared numbers); a configuration is
``configs/<name>.json``; a traffic mix is ``traffic/<name>.json``, whose
``kind`` names the module ``harness/<kind>.py`` that drives it (``serve``,
``train``); a per-layer metric is read by ``read(run)`` in
``metrics/<name>.py``, or in ``metrics/<stem>.py`` for the name up to its
first dot; a kernel pattern is ``kernels/<name>.json``.
Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]           # portbench/
CHECKOUT = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "genpose_tpu"}
# one H100 SXM (NVIDIA's data sheet; dense rates): float32 outside the
# tensor cores, and HBM3
PEAKS = {"H100": {"float32_ops_per_s": 67e12, "bytes_per_s": 3.35e12}}


def load(kind: str, name: str) -> Dict:
    """``portbench/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def names(kind: str, suffix: str = ".json") -> List[str]:
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(f"*{suffix}"))


def benchmark() -> Dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell(workload: str):
    """(cell, configuration, traffic) of a workload."""
    c = load("cells", workload)
    return c, load("configs", c["config"]), load("traffic", c["traffic"])


def forbidden_loaded() -> List[str]:
    """Top-level module names in ``sys.modules`` that the benchmark may not
    load, compared whole (``genpose_tpu_torch`` is not ``genpose_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=False).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def peaks(device: torch.device) -> Optional[Dict[str, float]]:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAKS.items() if k in name), None)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seed_of(seed: int, *parts: int) -> int:
    """A 63-bit seed for one stream of a run (weights, a request's clouds,
    its prior...), the same for the same (seed, parts)."""
    ss = np.random.SeedSequence([seed % (1 << 64), *(p % (1 << 63) for p in parts)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def make_weights(spec, device: torch.device, seed: int, perturb: float = 0.01) -> Dict:
    """One net's weights from ``seed``, made on ``device`` in two draws: the
    seeded initialiser of each entry (lecun normal, the tails' normal, ones,
    zeros, the Fourier features, BatchNorm's 0 / 1 statistics), plus
    ``perturb`` x N(0, 1) on every trained entry, so that the zero-initialised
    tail outputs do real work (the derandomisation of timing runs)."""
    from reference.genpose_ref import is_buffer

    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = generator(device, seed)
    base = torch.randn(sum(sizes), generator=gen, device=device)
    noise = torch.randn(sum(sizes), generator=gen, device=device) * perturb
    out, at = {}, 0
    for (name, shape, init), n in zip(spec, sizes):
        x = base[at:at + n].reshape(shape)
        if init == "lecun":
            w = x / math.sqrt(shape[-1])
        elif init == "tail":
            w = x / math.sqrt(1024 + 128 + 256)
        elif init == "fourier":
            w = x * 30.0
        elif init in ("one", "var1"):
            w = torch.ones(shape, device=device)
        elif init in ("zero", "mean0"):
            w = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown initialiser {init!r}")
        if not is_buffer(name):
            w = w + noise[at:at + n].reshape(shape)
        out[name] = w.contiguous()
        at += n
    return out


def pair_weights(config: Dict, device: torch.device, seed: int):
    """The score net's and the energy net's weights of a run."""
    from reference.genpose_ref import param_spec

    spec = param_spec(config["encoder_stages"])
    return (make_weights(spec, device, seed_of(seed, 0, 0)),
            make_weights(spec, device, seed_of(seed, 0, 1)))


def load_weights(agent, weights: Dict) -> None:
    """The weights into a port agent's model, every entry checked by name
    and shape (BatchNorm's batch counters start at 0)."""
    state = dict(weights)
    for k, v in agent.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros_like(v)
    agent.model.load_state_dict(state, strict=True)


def port_config(config: Dict, **fields):
    """The port's ``Config`` for a configuration file and a traffic's fields."""
    from genpose_tpu_torch.config import Config

    keys = ("pts_encoder", "pointnet2_params", "regression_head", "pose_mode", "sde_mode",
            "energy_mode", "s_theta_mode", "norm_energy", "compute_dtype", "num_points")
    return Config(**{k: config[k] for k in keys}, **fields)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Spans:
    """Spans around calls into the program, wrapped from outside.  While
    ``on``, each call is timed on the host clock with the device
    synchronised on both sides; otherwise the calls run as they are."""

    def __init__(self, device: torch.device):
        self.device, self.on = device, False
        self.ms: Dict[str, List[float]] = {}
        self._saved = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        sync(self.device)
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Time every call of ``owner.attr`` as the span ``name`` (an
        instance attribute shadows the method until ``unwrap``)."""
        fn = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        self._saved.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, wrapper)

    def unwrap(self) -> None:
        for owner, attr, prev in reversed(self._saved):
            restore(owner, attr, prev)
        self._saved.clear()


def restore(owner, attr: str, prev) -> None:
    """Put back the instance attribute a wrapper shadowed (or none)."""
    if prev is None:
        delattr(owner, attr)
    else:
        setattr(owner, attr, prev)


class Tap:
    """Keeps what ``owner.attr`` returns, call by call, so that the check
    can judge the program's own outputs after the window."""

    def __init__(self, owner, attr: str):
        self.owner, self.attr, self.outs = owner, attr, []
        self.prev = vars(owner).get(attr)
        fn = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.outs.append(out)
            return out

        setattr(owner, attr, wrapper)

    def close(self) -> None:
        restore(self.owner, self.attr, self.prev)


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: Dict, checks: Dict) -> None:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output, the numbers under their own
    key at its end."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
