"""Batching + prefetching loaders: a copy of anomalyclip_tpu/data/loader.py,
numpy only.

Replaces the reference's pair of torch DataLoaders that Lightning combines into
(normal_batch, abnormal_batch) steps with max_size_cycle semantics (reference:
src/data/anomaly_clip_datamodule.py:144-163). Design:

- a :class:`TrainBatch` carries the abnormal and normal halves as separate fields,
  so the train step can take each half as it is and concatenate
  abnormal-first on device (the order convention the selector/loss rely on,
  anomaly_clip_module.py:173-178);
- item loading is fanned out over a thread pool and whole batches are prefetched on
  a background thread so host IO overlaps device compute (the reference leans on
  torch DataLoader workers for this);
- every epoch reshuffles with an explicit numpy Generator — reproducible,
  checkpoint-resumable, no global RNG.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Optional

import numpy as np

from anomalyclip_tpu_torch.data.dataset import TestItem, VideoDataset


def limit_count(total: int, limit) -> int:
    """Resolve a Lightning-style ``limit_*_batches`` knob to a batch count.

    ``None`` = everything, a float <= 1.0 = fraction of ``total`` (at least 1),
    an int = absolute cap. Shared by the train module's steps-per-epoch /
    val / test limits and the artifact-eval CLI so the semantics cannot drift
    (reference contract: Lightning Trainer ``limit_train/val/test_batches``)."""
    if limit is None:
        return total
    if isinstance(limit, float) and limit <= 1.0:
        return max(int(total * limit), 1)
    return min(int(limit), total)


class TrainBatch(NamedTuple):
    abnormal_features: np.ndarray  # (b/2, n*l, D) or frames
    abnormal_labels: np.ndarray  # (b/2,)
    normal_features: np.ndarray  # (b/2, n*l, D)
    normal_labels: np.ndarray  # (b/2,)


class DualStreamTrainLoader:
    """Paired abnormal/normal epochs: each stream shuffles independently, batches
    are batch_size//2 from each, drop_last. Epoch length = MAX of the two stream
    lengths with the shorter stream cycling (reshuffled on each wrap) — Lightning
    1.8's ``max_size_cycle`` semantics for a list of train loaders
    (anomaly_clip_datamodule.py:144-163), which the reference relies on: e.g.
    ShanghaiTech has ~3x more normal than abnormal train videos, and min-length
    zip would run ~3x fewer optimizer steps per epoch than the reference."""

    def __init__(
        self,
        normal: VideoDataset,
        abnormal: VideoDataset,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``process_index``/``process_count``: per-rank data sharding for
        multi-host training (the Lightning DistributedSampler analogue,
        reference configs/trainer/ddp.yaml:3-8 via use_distributed_sampler).
        Every process builds the IDENTICAL global epoch plan (same seed, same
        permutations, same per-item augmentation seeds), then loads only its
        contiguous block of each global batch — rows
        [p*half/P, (p+1)*half/P) of each half, in rank order — so host
        decode/IO scales with ranks while the assembled global batch is
        bit-identical to the single-process one (pinned in
        tests/test_torch_data.py)."""
        if batch_size % 2 != 0:
            raise ValueError("batch_size must be even (abnormal/normal halves)")
        if (batch_size // 2) % process_count != 0:
            raise ValueError(
                f"per-half batch {batch_size // 2} must divide evenly over "
                f"{process_count} processes"
            )
        if not 0 <= process_index < process_count:
            raise ValueError((process_index, process_count))
        self.normal = normal
        self.abnormal = abnormal
        self.half = batch_size // 2
        self.process_index = process_index
        self.process_count = process_count
        self.local_half = self.half // process_count
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.epoch = 0
        # one persistent pool for the loader's lifetime: creating/tearing down a
        # ThreadPoolExecutor per batch costs thread spawns on the hot input path
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def __len__(self) -> int:
        n, a = len(self.normal) // self.half, len(self.abnormal) // self.half
        # a stream with fewer items than a half-batch cannot cycle into one
        return max(n, a) if min(n, a) > 0 else 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def close(self) -> None:
        """Join the worker pool — call when done with the loader (multirun jobs
        otherwise accumulate idle pools across trials in one process)."""
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _epoch_plan(self):
        rng = np.random.default_rng((self.seed, self.epoch))

        def half_chunks(dataset):
            # cycle: reshuffle whenever the stream is exhausted (Lightning
            # restarts the shorter DataLoader, which reshuffles)
            while True:
                idx = rng.permutation(len(dataset))
                for b in range(len(dataset) // self.half):
                    yield idx[b * self.half : (b + 1) * self.half]

        a_chunks = half_chunks(self.abnormal)
        n_chunks = half_chunks(self.normal)
        for _ in range(len(self)):
            yield (
                next(a_chunks),
                next(n_chunks),
                rng.integers(np.iinfo(np.int64).max),
            )

    def _make_batch(self, a_ids, n_ids, batch_seed) -> TrainBatch:
        rng = np.random.default_rng(batch_seed)
        # the FULL global seed draw on every process (cheap), then the local
        # block slice: rank p's items are bit-identical to rows
        # [p*local_half, (p+1)*local_half) of the single-process batch
        item_seeds = rng.integers(np.iinfo(np.int64).max, size=2 * self.half)
        lo = self.process_index * self.local_half
        hi = lo + self.local_half
        # submit BOTH halves before collecting either: Executor.map enqueues
        # its tasks eagerly, so the two halves' decodes overlap in the pool —
        # list()-ing the abnormal half first would leave workers idle through
        # each half's tail (up to ~2x per-batch host latency on the
        # from-frames path when local_half is small next to num_workers)
        a_iter = self._pool.map(
            lambda args: self.abnormal.train_item(
                int(args[0]), np.random.default_rng(int(args[1]))
            ),
            zip(a_ids[lo:hi], item_seeds[: self.half][lo:hi]),
        )
        n_iter = self._pool.map(
            lambda args: self.normal.train_item(
                int(args[0]), np.random.default_rng(int(args[1]))
            ),
            zip(n_ids[lo:hi], item_seeds[self.half :][lo:hi]),
        )
        a_items = list(a_iter)
        n_items = list(n_iter)
        a_feats = np.stack([f for f, _ in a_items])  # (b/2, ncrops, t, ...)
        n_feats = np.stack([f for f, _ in n_items])
        return TrainBatch(
            abnormal_features=a_feats,
            abnormal_labels=np.array([l for _, l in a_items], dtype=np.int32),
            normal_features=n_feats,
            normal_labels=np.array([l for _, l in n_items], dtype=np.int32),
        )

    def __iter__(self) -> Iterator[TrainBatch]:
        return _prefetched(
            (self._make_batch(*plan) for plan in self._epoch_plan()), self.prefetch
        )


class SequentialTestLoader:
    """Per-video test iteration (batch_size_test=1 semantics,
    anomaly_clip_datamodule.py:165-193), with background prefetch.

    ``shard=(p, P)`` restricts the loader to global video indices
    p, p+P, p+2P, ... of the (limit-truncated) dataset — per-rank eval
    sharding: each host loads and scores only its stride of the videos
    (the reference evaluates rank-zero-only, anomaly_clip_module.py:458).
    ``global_indices()`` exposes the indices for cross-process reassembly.
    """

    def __init__(
        self,
        dataset: VideoDataset,
        prefetch: int = 2,
        limit: Optional[int] = None,
        shard: tuple = (0, 1),
    ):
        self.dataset = dataset
        self.prefetch = prefetch
        self.limit = limit
        p, count = shard
        if not 0 <= p < count:
            raise ValueError(shard)
        self.shard = (int(p), int(count))

    def _global_len(self) -> int:
        n = len(self.dataset)
        return min(n, self.limit) if self.limit is not None else n

    def global_indices(self) -> range:
        p, count = self.shard
        return range(p, self._global_len(), count)

    def __len__(self) -> int:
        return len(self.global_indices())

    def __iter__(self) -> Iterator[TestItem]:
        return _prefetched(
            (self.dataset.test_item(i) for i in self.global_indices()), self.prefetch
        )


def _prefetched(gen, depth: int):
    """Run a generator on a daemon thread with a bounded queue.

    Abandon-safe: when the consumer stops early (limit_train_batches breaking out
    of the epoch loop), the generator's close/GC sets ``stop`` and the worker exits
    instead of blocking forever on a full queue with its buffered batches pinned.
    """
    if depth <= 0:
        yield from gen
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as exc:  # surfaced on the consumer side
            _put(exc)

    threading.Thread(target=worker, daemon=True, name="anomalyclip-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
