"""Loaders: batched, bucketed by frame count, mapped on a thread pool.

Port of `combo_avs_tpu/data/loader.py`. Videos are grouped by frame count so
that every batch has one shape (AVSS mixes 5- and 10-frame videos).

* `TrainLoader`: the infinite shuffled training stream (ref: d2's
  TrainingSampler, train_net.py:111-123), mapped on `num_workers` threads
  and prefetched `prefetch` batches ahead on a thread of its own.
* `eval_loader`: one pass; within a batch the records are mapped on a
  thread pool, which the generator shuts down when it is exhausted or
  closed.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from combo_avs_torch.parallel.mesh import per_rank_batch

NUM_WORKERS = 4


def _stack_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class TrainLoader:
    """Infinite shuffled loader over per-video records; `next()` gives a
    stacked batch.

    The order is the JAX package's `TrainLoader`'s for the same seed: from
    RandomState(seed), a bucket drawn in proportion to its size, then a
    batch from that bucket's stream of permutations (no video twice within
    a permutation); with `num_shards` processes each takes its slice of the
    global batch (`batch_size` is the global batch, which the shards must
    divide). The mapper is called as `mapper(record, n)`, where n is the
    video's place in the global stream (batch by batch, slot by slot): the
    draws of a video's transform hang on that place, not on which worker
    thread gets to it first or which shard maps it, so any `num_workers`
    gives the same batches and shard r's batch is rows r*b .. (r+1)*b - 1
    of the one-shard loader's (the JAX mapper counts calls as they start,
    which fixes the order only with one worker).

    A failure in the mapper is raised by the next `next()`. `close()` stops
    the prefetch thread and shuts the worker pool down."""

    def __init__(self, records: List[dict], mapper: Callable[[dict, int], Dict[str, np.ndarray]],
                 batch_size: int, seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1):
        if not records:
            raise ValueError("no records to load")
        self.mapper = mapper
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.per_shard = per_rank_batch(batch_size, num_shards)  # refuses an uneven split
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.shard_index = shard_index
        self.buckets: Dict[int, List[dict]] = {}
        for r in records:
            self.buckets.setdefault(r["num_frames"], []).append(r)
        self._pool = ThreadPoolExecutor(max(1, num_workers))
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _indices(self) -> Iterator[Tuple[List[dict], int]]:
        """(this shard's records of each global batch, the global stream
        place of the first of them)."""
        streams = {k: iter(()) for k in self.buckets}
        sizes = {k: len(v) for k, v in self.buckets.items()}
        total = sum(sizes.values())
        per = self.per_shard
        lo = self.shard_index * per  # this shard's slots of a batch
        start = 0  # the global stream place of each batch's first video
        while True:
            r = self.rng.rand() * total
            acc = 0
            for k, n in sizes.items():
                acc += n
                if r <= acc:
                    break
            bucket = self.buckets[k]
            idx: List[int] = []
            while len(idx) < self.batch_size:
                for i in streams[k]:
                    idx.append(i)
                    if len(idx) == self.batch_size:
                        break
                else:
                    streams[k] = iter(self.rng.permutation(len(bucket)))
            yield [bucket[i] for i in idx[lo:lo + per]], start + lo
            start += self.batch_size

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self) -> None:
        try:
            for recs, first in self._indices():
                if self._stop.is_set():
                    return
                numbers = range(first, first + len(recs))
                samples = list(self._pool.map(self.mapper, recs, numbers))
                if not self._put(_stack_batch(samples)):
                    return
        except BaseException as e:  # raised again by __next__
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._queue.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        self._pool.shutdown(wait=True, cancel_futures=True)


def eval_loader(records: List[dict], mapper: Callable[[dict], Dict[str, np.ndarray]],
                batch_size: int = 1, pad: bool = False
                ) -> Iterator[Tuple[Dict[str, np.ndarray], List[dict]]]:
    """One pass over `records`, yielding (batch, the batch's records);
    batches never mix frame counts. With `pad`, the last batch of each
    frame count is filled to `batch_size` with copies of its last video
    marked `_pad` (to be computed, never scored), as
    `combo_avs_tpu/train/trainer.py::evaluate` pads its buckets."""
    by_t: Dict[int, List[dict]] = {}
    for r in records:
        by_t.setdefault(r["num_frames"], []).append(r)
    with ThreadPoolExecutor(NUM_WORKERS) as pool:
        for _, recs in sorted(by_t.items()):
            for i in range(0, len(recs), batch_size):
                chunk = recs[i:i + batch_size]
                if pad:
                    chunk = chunk + [dict(chunk[-1], _pad=True)] * (batch_size - len(chunk))
                batch = _stack_batch(list(pool.map(mapper, chunk)))
                yield batch, chunk
