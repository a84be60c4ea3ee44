"""Data parallelism, one process per device (counterpart of ``genpose_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ``dp`` mesh in one process, shards every batch
tensor on axis 0 and replicates the parameters; under ``jit`` every
reduction over a sharded axis is global, so BatchNorm statistics, the
gradient mean and RK45's error norm cover the global batch for free.  Here
each device has a process of its own, joined in a ``torch.distributed``
group (NCCL on cards, gloo on the CPU), and each of those reductions is made
explicitly where it happens:

- train-mode BatchNorm over the global batch (``models/layers.py::batch_norm``):
  all-reduces of the per-channel sums and the row count in the forward and
  of the gradient's sums in the backward (``_GlobalBatchNorm``);
- the gradient mean before the optimizer step (``average_gradients_``;
  ``training/agent.py::_optimize``);
- RK45's error norm and PC's mean score norm over every row of the
  integration (``mean_over_rows_``; ``diffusion/samplers.py``), outside any
  captured CUDA graph;
- the random numbers of a step: a rank draws the tensors of the global
  batch from the generator every rank holds in the same state, and keeps
  its own rows (``local_draw``), so the numbers are the single-process
  run's whatever the world size.

A group takes effect inside ``sharded(group)``: the trainer's steps, a
sharded evaluation chunk and ``InferencePipeline._run`` under a group.
Outside it, with no group at all and in a group of one, every function
here is the identity and every path runs as a single process does, bit for
bit.

``make_group`` joins the process group the environment describes
(``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or the one ``launch`` hands its workers; ``launch`` starts
one spawned worker per device (spawn, so no worker inherits a CUDA
context) and returns each rank's result.  A worker that raises ends the
whole run: the others are terminated and ``launch`` raises.  A request for
more cards than the machine has raises; so does NCCL with two ranks on one
card, unless gloo is asked for by name.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from genpose_tpu_torch.utils.device import resolve_device


@dataclass
class DPGroup:
    """This process's place in a data-parallel group: ``rank`` of ``world``
    processes, its ``device`` and the group's ``backend``."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes checkpoints, logs and result files."""
        return self.rank == 0


_active: Optional[DPGroup] = None


def active() -> Optional[DPGroup]:
    """The group of the enclosing ``sharded`` block, else None."""
    return _active


@contextlib.contextmanager
def sharded(group: Optional[DPGroup]):
    """Within the block, batches are this rank's rows of a global batch:
    draws keep this rank's rows, train-mode BatchNorm, gradients and the
    samplers' norms reduce over the group.  ``sharded(None)`` changes nothing."""
    global _active
    saved = _active
    _active = group
    try:
        yield group
    finally:
        _active = saved


def resolve_num_devices(num_devices: int, device="cuda") -> int:
    """The world size a request means: 0 is every visible card (one process
    on the CPU); more cards than the machine has raises, before anything
    else is done."""
    if torch.device(device).type == "cpu":
        return max(1, num_devices)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = num_devices or count
    if n > max(count, 1):
        raise RuntimeError(f"{n} devices requested for several cards; the machine has "
                           f"{count} card(s)" + ("" if count else " (CUDA is not available; "
                                                 "pass device='cpu' to run on the CPU)"))
    resolve_device(device)
    return n


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_group(num_devices: int = 0, device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> DPGroup:
    """This process's data-parallel group (JAX ``make_mesh``; 0 devices means
    the group's own size).  Joins the process group already made in this
    process, else the one ``init_method``/``rank``/``world_size`` name, else
    the one the environment names (``torchrun``), else makes a group of one
    at a free localhost port.  ``backend``: NCCL on cards and gloo on the
    CPU unless named; gloo on cards lets several ranks share one card.
    Raises when the group's size is not the request's."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    explicit_gloo = backend == "gloo" and dev.type == "cuda"
    if not dist.is_initialized():
        env = os.environ
        if init_method is None and "WORLD_SIZE" in env and "RANK" in env:
            init_method, rank, world_size = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
        elif init_method is None:
            init_method, rank, world_size = f"tcp://localhost:{free_port()}", 0, 1
        local = int(os.environ.get("LOCAL_RANK", rank))
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            if local >= count and not explicit_gloo:
                raise RuntimeError(f"rank {rank} needs card {local}; the machine has {count} "
                                   "(several ranks share a card only over gloo, asked by name)")
            torch.cuda.set_device(local % count)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    rank, world = dist.get_rank(), dist.get_world_size()
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, {backend} was asked for")
    want = num_devices or world
    if want != world:
        raise RuntimeError(f"a group of {want} ranks was asked for, this one has {world}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return DPGroup(rank, world, dev, backend)


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives (gloo takes CUDA tensors through the host)
# ---------------------------------------------------------------------------

def _through_host(group: DPGroup, t: torch.Tensor) -> bool:
    return group.backend == "gloo" and t.is_cuda


def all_reduce_(t: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """In-place sum over the group."""
    if _through_host(group, t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, group: DPGroup, src: int = 0) -> torch.Tensor:
    if _through_host(group, t):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t


@torch.no_grad()
def average_gradients_(grads: dict, group: Optional[DPGroup]) -> dict:
    """Each gradient replaced by its mean over the group (each rank's loss is
    the mean over its own rows of equal shards), in one all-reduce.
    Identity without a group or at world 1."""
    if group is None or group.world == 1:
        return grads
    keys = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in keys])
    all_reduce_(flat, group).div_(group.world)
    out, lo = {}, 0
    for k in keys:
        n = grads[k].numel()
        out[k] = flat[lo:lo + n].view_as(grads[k])
        lo += n
    return out


@torch.no_grad()
def mean_over_ranks(values: dict, group: Optional[DPGroup]) -> dict:
    """Scalars (losses to log) averaged over the group, in one all-reduce.
    Identity without a group or at world 1."""
    if group is None or group.world == 1 or not values:
        return values
    keys = list(values)
    flat = torch.stack([torch.as_tensor(values[k], dtype=torch.float32,
                                        device=group.device).reshape(()) for k in keys])
    all_reduce_(flat, group).div_(group.world)
    return {k: flat[i] for i, k in enumerate(keys)}


@torch.no_grad()
def mean_over_rows_(means: torch.Tensor, rows: int) -> torch.Tensor:
    """In place: ``means``, each a mean over this rank's ``rows`` rows,
    become means over the rows of every rank of the active group (from each
    rank's sum and row count).  Nothing happens outside ``sharded`` or in a
    group of one."""
    group = _active
    if group is None or group.world == 1:
        return means
    n = torch.full((1,), float(rows), dtype=means.dtype, device=means.device)
    buf = all_reduce_(torch.cat([means.reshape(-1) * rows, n]), group)
    means.copy_((buf[:-1] / buf[-1]).view_as(means))
    return means


# ---------------------------------------------------------------------------
# rows of a global batch
# ---------------------------------------------------------------------------

def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m >= n (padding a ragged batch so that it divides
    over the group)."""
    return ((n + m - 1) // m) * m


def _block(n: int, group: DPGroup):
    if n % group.world:
        raise ValueError(f"a batch of {n} rows does not divide over {group.world} ranks")
    per = n // group.world
    return group.rank * per, per


def shard_batch(group: Optional[DPGroup], tree):
    """This rank's rows of every array (tensor, numpy array or list) in a
    dict/list/tuple tree: contiguous blocks of axis 0, like ``P('dp')``.
    0-dim leaves stay as they are.  Identity without a group or at world 1."""
    if group is None or group.world == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(group, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(shard_batch(group, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        if tree.ndim == 0:
            return tree
        lo, per = _block(tree.shape[0], group)
        return tree[lo:lo + per]
    if isinstance(tree, list):
        lo, per = _block(len(tree), group)
        return tree[lo:lo + per]
    return tree


def local_draw(draw: Callable[[int], object], rows: int, axis: int = 0):
    """``draw(n)`` makes the random tensors (one tensor or a dict/tuple of
    them) of n rows on ``axis``.  Inside ``sharded(group)`` the global batch's
    n = rows * world are drawn and this rank's block of ``rows`` is kept, so
    every rank consumes the generator alike and the numbers are the ones one
    process would draw; elsewhere ``draw(rows)``."""
    group = _active
    if group is None or group.world == 1:
        return draw(rows)
    lo = group.rank * rows

    def keep(x):
        if isinstance(x, dict):
            return {k: keep(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(keep(v) for v in x)
        return x.narrow(axis, lo, rows).contiguous()

    return keep(draw(rows * group.world))


@torch.no_grad()
def all_gather_rows(group: Optional[DPGroup], tree):
    """The inverse of ``shard_batch``: every rank's rows of each tensor or
    numpy array, concatenated in rank order on every rank."""
    if group is None or group.world == 1:
        return tree
    if isinstance(tree, dict):
        return {k: all_gather_rows(group, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(all_gather_rows(group, v) for v in tree)
    if isinstance(tree, np.ndarray):
        return all_gather_rows(group, torch.from_numpy(np.ascontiguousarray(tree))).numpy()
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.contiguous()
    if _through_host(group, t) or t.device.type == "cpu":
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(group.world)]
        dist.all_gather(parts, host)
        return torch.cat(parts).to(t.device)
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def all_gather_objects(group: Optional[DPGroup], obj) -> list:
    """Every rank's picklable ``obj``, in rank order ([obj] without a group)."""
    if group is None or group.world == 1:
        return [obj]
    out = [None] * group.world
    dist.all_gather_object(out, obj)
    return out


@torch.no_grad()
def replicate(group: Optional[DPGroup], *agents) -> None:
    """Broadcast each agent's state from rank 0 (JAX ``replicate``): the
    parameters, BatchNorm statistics and Fourier ``W``, the optimizer
    moments, the EMA shadow, the step and the EMA count.  After it every
    rank holds rank 0's state."""
    if group is None or group.world == 1:
        return
    for agent in agents:
        st = agent.state
        tensors = [*agent.model.parameters(), *agent.model.buffers()]
        for moments in (st.opt_state or {}).values():
            tensors += [moments[k] for k in sorted(moments)]
        shadow = st.ema.shadow or {}
        tensors += [shadow[k] for k in sorted(shadow)]
        counts = torch.tensor([st.step, st.ema.num_updates, st.opt_state is not None,
                               st.ema.shadow is not None], dtype=torch.int64,
                              device=group.device)
        ref = broadcast_(counts.clone(), group)
        if bool((ref[2:] != counts[2:]).any()):
            raise RuntimeError("ranks disagree on which optimizer and EMA state exists")
        for t in tensors:
            broadcast_(t.data, group)
        st.step, st.ema.num_updates = int(ref[0]), int(ref[1])


def barrier(group: Optional[DPGroup]) -> None:
    if group is not None and group.world > 1:
        if group.backend == "nccl":
            dist.barrier(device_ids=[group.device.index])
        else:
            dist.barrier()


# ---------------------------------------------------------------------------
# one spawned worker per device
# ---------------------------------------------------------------------------

def _worker(rank: int, fn: Callable, world: int, device: str, backend: Optional[str],
            init_method: str, args: Sequence, out_dir: str, threads: int) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cpu":  # the parent's threads, shared out
        torch.set_num_threads(max(1, threads // world))
    group = make_group(world, device, backend, init_method=init_method, rank=rank,
                       world_size=world)
    try:
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy_group()


def launch(fn: Callable, num_devices: int, device="cuda", args: Sequence = (),
           backend: Optional[str] = None) -> List[object]:
    """Run ``fn(group, *args)`` in ``num_devices`` spawned processes, one per
    device (0: every visible card), joined in one group; returns each rank's
    result (saved with ``torch.save``), in rank order.  A worker that raises
    ends the run: the others are terminated and this raises."""
    import torch.multiprocessing as mp

    world = (num_devices if backend == "gloo" and num_devices
             else resolve_num_devices(num_devices, device))
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_worker, nprocs=world, join=True,
                 args=(fn, world, str(device), backend, f"tcp://localhost:{free_port()}",
                       tuple(args), out_dir, torch.get_num_threads()))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
