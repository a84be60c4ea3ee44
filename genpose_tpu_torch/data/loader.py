"""Prefetching batch loader over the NOCS dataset (counterpart of ``genpose_tpu/data/loader.py``).

- ``collate`` stacks sample dicts into numpy batches (strings as lists);
- ``camera_real_indices`` is the CAMERA:Real = 3:1 epoch resampling of the
  reference (``datasets_genpose.py:545-556``);
- ``DataLoader`` shuffles the indices with its own ``np.random.Generator``,
  fetches each batch's samples on a pool of ``num_workers`` threads
  (``workers_mode="thread"``, the default: PNG inflate and numpy release
  the GIL for part of the work) or forked processes (``"process"``, one
  pool forked once from the consumer's thread at the first ``__iter__`` and
  kept across epochs), and keeps up to ``prefetch`` collated batches in a
  bounded queue filled by a producer thread.  A worker's error is raised in
  the consumer; an iterator that is dropped or left early stops and joins
  its producer;
- ``get_data_loaders_from_cfg`` builds the train / val / test loaders of a
  config (``datasets_genpose.py:587-640``).

The parent numbers each index's visits in dispatch order, across epochs,
and the dataset draws from ``(seed, index, visit)``
(``data/nocs.py::NOCSDataset.fetch``), so both modes give the same batches,
and the JAX loader's for the same seed.  Batches are numpy: the training
loop moves them to the device, and forked workers touch nothing of CUDA.

With ``shard=(rank, world)`` (the trainer under a data-parallel group) the
loader yields rank ``rank``'s contiguous block of each global batch: the
same permutation, ``drop_last`` and visit numbers as one loader over the
global batch, but only this rank's samples are fetched.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_worker_dataset = None  # a process worker's copy of the dataset


def _init_worker(dataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset


def _fetch(index: int, visit: int):
    return _worker_dataset.fetch(int(index), int(visit))


def collate(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into batched numpy arrays (strings stay a list)."""
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out


def camera_real_indices(subset_len: List[int], percentage_data: float,
                        rng: np.random.Generator) -> np.ndarray:
    """CAMERA:Real 3:1 resampled index list (ref ``datasets_genpose.py:545-556``)."""
    camera_len, real_len = subset_len
    real_indices = list(range(camera_len, camera_len + real_len))
    camera_indices = list(range(camera_len))
    n_repeat = max((camera_len // 3 - real_len) // max(real_len, 1), 0)
    idx = camera_indices + real_indices * n_repeat
    rng.shuffle(idx)
    size = int(percentage_data * len(idx))
    return np.asarray(idx[:size])


class DataLoader:
    """Map-style loader: shuffling, pooled fetch, bounded prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = False, indices: Optional[np.ndarray] = None,
                 prefetch: int = 2, seed: int = 0, workers_mode: str = "thread",
                 shard: Optional[Tuple[int, int]] = None):
        if workers_mode not in ("thread", "process"):
            raise ValueError(f"workers_mode={workers_mode!r} not in ('thread', 'process')")
        if workers_mode == "process" and not hasattr(dataset, "fetch"):
            # forked workers' own visit counters would restart every fork and
            # repeat the augmentation draws each epoch
            raise TypeError("workers_mode='process' requires the dataset to expose "
                            "fetch(index, visit) (see NOCSDataset.fetch)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.workers_mode = workers_mode
        self.drop_last = drop_last
        self.base_indices = (np.asarray(indices) if indices is not None
                             else np.arange(len(dataset)))
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self._visits: Dict[int, int] = {}  # per index, across epochs
        self._pool: Optional[ProcessPoolExecutor] = None
        self.shard = shard

    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            pool = ProcessPoolExecutor(max_workers=self.num_workers,
                                       mp_context=multiprocessing.get_context("fork"),
                                       initializer=_init_worker, initargs=(self.dataset,))
            # a fork pool starts all its workers at the first submit: make that
            # happen here, on the consumer's thread, not on the producer's
            pool.submit(int, 0).result(timeout=120)
            self._pool = pool
        return self._pool

    def close(self) -> None:
        """Shut down the process pool (nothing to do in thread mode)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __len__(self):
        n = len(self.base_indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[np.ndarray]:
        idx = self.base_indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def _assign_visits(self, batches: List[np.ndarray]) -> List[np.ndarray]:
        """Visit numbers in dispatch order; an index repeated within an epoch
        (the CAMERA:Real resampling) gets a new one each time."""
        out = []
        for batch_idx in batches:
            v = np.empty(len(batch_idx), np.int64)
            for j, ix in enumerate(batch_idx):
                v[j] = self._visits[int(ix)] = self._visits.get(int(ix), 0) + 1
            out.append(v)
        return out

    def _local(self, rows: List[np.ndarray]) -> List[np.ndarray]:
        """This rank's block of each global batch's rows (all without a shard)."""
        if self.shard is None:
            return rows
        rank, world = self.shard
        out = []
        for r in rows:
            if len(r) % world:
                raise ValueError(f"a batch of {len(r)} samples does not divide over {world} ranks")
            per = len(r) // world
            out.append(r[rank * per:(rank + 1) * per])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        visits = self._local(self._assign_visits(batches))
        batches = self._local(batches)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        proc_pool = self._ensure_pool() if self.workers_mode == "process" else None
        ds_fetch = getattr(self.dataset, "fetch", None)

        def put(item) -> bool:
            """Enqueue unless the consumer has gone; False once it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # the sentinel, or the worker's exception, is always enqueued, so
            # the consumer never waits on a producer that has ended
            err = None
            try:
                if proc_pool is not None:
                    thread_pool, pool, fetch = None, proc_pool, _fetch
                else:
                    thread_pool = pool = ThreadPoolExecutor(max_workers=self.num_workers)
                    fetch = ds_fetch or (lambda index, visit: self.dataset[int(index)])
                try:
                    for batch_idx, batch_visits in zip(batches, visits):
                        if stop.is_set() or not put(
                                collate(list(pool.map(fetch, batch_idx, batch_visits)))):
                            break
                finally:
                    if thread_pool is not None:
                        thread_pool.shutdown(wait=True)
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                err = e
                if proc_pool is not None:
                    self.close()  # a broken pool is not reused: the next epoch forks anew
            put(err if err is not None else sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion and when the caller leaves the loop or drops the
            # iterator: stop the producer, empty the queue, join
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
            t.join()


def get_data_loaders_from_cfg(cfg, data_type=("train", "val", "test"),
                              shard: Optional[Tuple[int, int]] = None):
    """Loaders per split (ref ``datasets_genpose.py:587-640``): train from
    ``cfg.train_source`` (CAMERA+Real resampled 3:1), val from
    ``cfg.val_source`` and test from ``cfg.test_source`` in test mode with
    ``mini_bs`` batches.  A train loader drops its last ragged batch when
    the split holds at least one full batch.  ``shard=(rank, world)``: the
    train loader yields that rank's rows of each global batch."""
    from genpose_tpu_torch.data.nocs import NOCSDataset, refuse_rgb_encoder

    refuse_rgb_encoder(cfg.pts_encoder)
    loaders = {}
    rng = np.random.default_rng(cfg.seed)

    def build(source, mode, batch_size, percentage, shard=None):
        ds = NOCSDataset(data_dir=cfg.data_path, source=source, mode=mode, n_pts=cfg.num_points,
                         img_size=cfg.img_size, per_obj=cfg.per_obj, dzi_params=cfg.dzi,
                         deform_2d_params=cfg.deform_2d, seed=cfg.seed)
        indices = None
        if source == "CAMERA+Real" and mode == "train":
            indices = camera_real_indices(ds.subset_len, percentage, rng)
        elif percentage < 1.0:
            indices = rng.permutation(len(ds))[:int(percentage * len(ds))]
        n_idx = len(indices) if indices is not None else len(ds)
        return DataLoader(ds, batch_size=batch_size, shuffle=(mode == "train"),
                          num_workers=cfg.num_workers if mode == "train" else 1,
                          drop_last=mode == "train" and n_idx >= batch_size, indices=indices,
                          seed=cfg.seed, workers_mode=cfg.loader_mode, shard=shard)

    if "train" in data_type:
        loaders["train_loader"] = build(cfg.train_source, "train", cfg.batch_size,
                                        cfg.percentage_data_for_train, shard)
    if "val" in data_type:
        loaders["val_loader"] = build(cfg.val_source, "test", cfg.mini_bs,
                                      cfg.percentage_data_for_val)
    if "test" in data_type:
        loaders["test_loader"] = build(cfg.test_source, "test", cfg.mini_bs,
                                       cfg.percentage_data_for_test)
    return loaders
