"""The eval loader: batched, bucketed by frame count, mapped on a thread
pool.

Port of `combo_avs_tpu/data/loader.py::eval_loader`. Videos are grouped by
frame count so that every batch has one shape (AVSS mixes 5- and 10-frame
videos); within a batch the records are mapped on a thread pool, which the
generator shuts down when it is exhausted or closed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np


NUM_WORKERS = 4


def _stack_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


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
