"""Devices and shards of the data-parallel run.

Counterpart of `combo_avs_tpu/parallel/mesh.py`. The JAX package puts every
chip in one `Mesh` with the batch sharded on its "data" axis, and XLA
inserts the gradient psum. The port has no mesh object: one process drives
one device, as the reference's DDP does (ref: train_net.py:284-291), and
the sums over ranks are explicit (`parallel/distributed.py`). What is left
of the mesh is where each rank runs and which part of the data it takes:

* `local_device`: the local rank's card, or the CPU when asked;
* `per_rank_batch` / `shard_batch`: the global SOLVER.IMS_PER_BATCH split
  into equal per-rank batches (rank r takes rows r*b .. (r+1)*b - 1, as
  JAX's `shard_batch` places them), refused when the ranks do not divide it;
* `shard_records`: the round-robin split of the evaluation records
  (combo_avs_tpu/train/trainer.py:104-110).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def local_device(local_rank: int, device: str = "cuda") -> torch.device:
    """`cuda:<local_rank>`, or the CPU when `device` is "cpu"."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank)


def per_rank_batch(global_batch: int, world: int) -> int:
    """The videos each of `world` ranks takes of a global batch."""
    if world < 1 or global_batch % world:
        raise ValueError(f"SOLVER.IMS_PER_BATCH = {global_batch} does not split over "
                         f"{world} ranks")
    return global_batch // world


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """Rank `rank`'s rows of a global batch (every array's leading axis)."""
    b = per_rank_batch(len(next(iter(batch.values()))), world)
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def shard_records(records: List[dict], rank: int, world: int) -> List[dict]:
    """Rank `rank`'s evaluation records: every `world`-th from `rank` on."""
    if world <= 1:
        return records
    return records[rank::world]
