"""Process groups, sums over ranks, and the local launcher.

Counterpart of `combo_avs_tpu/parallel/distributed.py`. The reference runs
one NCCL process per GPU (detectron2's `launch`, ref: train_net.py:284-291)
and all_gathers its evaluator meters (ref: sem_seg_evaluation.py:256-265).
The JAX package puts every chip in one mesh instead; the port keeps the
reference's shape with `torch.distributed`:

* `initialize()` joins this process to the group: NCCL for a CUDA device,
  gloo for the CPU (two ranks that share one card pass backend="gloo").
  Without arguments it reads torchrun's RANK, WORLD_SIZE and
  MASTER_ADDR/MASTER_PORT when they are set, as `jax.distributed` discovers
  its coordinator;
* `World`: this process's rank, the number of ranks and the sums over them.
  `current()` is the initialized group's world, else the world of one, whose
  sums, barrier and broadcast do nothing;
* `all_sum_array` and `merge_evaluator_across_hosts`: the evaluator
  accumulators summed over ranks in float64;
* `launch()`: N local ranks in N processes (`torch.multiprocessing`), d2's
  `launch(num_gpus)`.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from combo_avs_torch.parallel.mesh import local_device

# gradients are summed in flat buckets of at most this many bytes
BUCKET_BYTES = 64 * 2**20
TIMEOUT = datetime.timedelta(minutes=30)


class World:
    """`size` ranks of the default process group, of which this process is
    `rank`. With size 1 every method returns at once. Tests substitute
    another world (ranks as threads) through the keyword every data-parallel
    function takes."""

    def __init__(self, rank: int = 0, size: int = 1):
        self.rank, self.size = rank, size

    @property
    def main(self) -> bool:
        return self.rank == 0

    def all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def broadcast_(self, t: torch.Tensor) -> None:
        """Overwrite `t` with rank 0's, in place."""
        if self.size > 1:
            dist.broadcast(t, 0)


def current() -> World:
    """The world of the initialized default group, else the world of one."""
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size())
    return World()


def is_main_process() -> bool:
    return current().main


def world_size() -> int:
    return current().size


def _init_method(coordinator: str) -> str:
    """"host:port" -> "tcp://host:port"; a URL ("tcp://", "file://") as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: Optional[torch.device | str] = None) -> int:
    """Join the default process group and return this process's rank.

    `coordinator` is "host:port" (or a "tcp://" or "file://" URL) that every
    rank names alike, `num_processes` the number of ranks and `process_id`
    this one. Without them the torchrun variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) are read when RANK and WORLD_SIZE are set;
    otherwise nothing is joined and the rank is 0. `device` is the rank's
    device ("cuda" by default: the current CUDA device, which becomes the
    rank's); the backend is NCCL for a CUDA device and gloo for the CPU
    unless `backend` names one. A one-element sum over the new group checks
    it before this returns."""
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator is None and num_processes is None and not env:
        return 0
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator is None and num_processes is None:
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process launch needs the coordinator, the number of "
                             "processes and this process's id")
        dist.init_process_group(backend, init_method=_init_method(coordinator),
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    # one small sum checks the group, and sets up the backend's communicator,
    # before the run depends on it
    check = torch.ones((), device=device if backend == "nccl" else "cpu")
    dist.all_reduce(check)
    if int(check) != dist.get_world_size():
        raise RuntimeError(f"the process group's check summed to {int(check)}, not "
                           f"{dist.get_world_size()}")
    return dist.get_rank()


def _buckets(tensors: Iterable[torch.Tensor], bucket_bytes: int):
    """Runs of consecutive tensors of one type and device, at most
    `bucket_bytes` a run (a larger tensor alone)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + nbytes > bucket_bytes):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _through_flat(bucket: List[torch.Tensor], op: Callable[[torch.Tensor], object]) -> None:
    """`op` on one flat copy of `bucket`, then the copy written back."""
    flat = torch.cat([t.reshape(-1) for t in bucket])
    op(flat)
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_sum_tensors_(tensors: Sequence[torch.Tensor], world: Optional[World] = None,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum `tensors` over the ranks in place, a few flat buckets at a time
    (consecutive tensors of one type and device, at most `bucket_bytes`
    each, as DDP's buckets), not one call per tensor. Every rank must pass
    the same shapes in the same order."""
    world = world or current()
    if world.size > 1:
        for bucket in _buckets(tensors, bucket_bytes):
            _through_flat(bucket, world.all_sum_)


def broadcast_module_(module: torch.nn.Module, world: Optional[World] = None) -> None:
    """Every parameter and buffer of `module` set to rank 0's, in flat
    buckets."""
    world = world or current()
    if world.size > 1:
        with torch.no_grad():
            for bucket in _buckets([*module.parameters(), *module.buffers()], BUCKET_BYTES):
                _through_flat(bucket, world.broadcast_)


def _group_device() -> torch.device:
    """The device the default group's collectives take tensors on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_sum_array(x, world: Optional[World] = None) -> np.ndarray:
    """A small numpy array summed over the ranks, in float64 (the evaluator
    accumulators); integer arrays come back as int64. The world of one
    returns `x` as it is."""
    world = world or current()
    if world.size == 1:
        return x
    arr = np.asarray(x)
    device = _group_device() if dist.is_initialized() else torch.device("cpu")
    t = torch.from_numpy(np.array(arr, np.float64)).to(device)
    out = world.all_sum_(t).cpu().numpy()
    return out.astype(np.int64) if np.issubdtype(arr.dtype, np.integer) else out


def merge_evaluator_across_hosts(evaluator, world: Optional[World] = None):
    """Sum an evaluator's accumulators over the ranks in place (the
    reference all_gathers its meters, ref: sem_seg_evaluation.py:256-265):
    S4/MS3's `_miou_sum`, `_f_sum`, `_count`, AVSS's `_iou_pc`, `_f_pc`,
    `_cls_pc`. The world of one leaves it as it is."""
    world = world or current()
    if world.size == 1:
        return evaluator
    for attr in ("_miou_sum", "_f_sum", "_count"):
        if hasattr(evaluator, attr):
            v = np.asarray(getattr(evaluator, attr), np.float64)
            setattr(evaluator, attr, type(getattr(evaluator, attr))(all_sum_array(v, world)))
    for attr in ("_iou_pc", "_f_pc", "_cls_pc"):
        if hasattr(evaluator, attr):
            setattr(evaluator, attr, all_sum_array(getattr(evaluator, attr), world))
    return evaluator


def rank_seed(seed: int, rank: int) -> int:
    """A seed of its own for each rank's dropout stream, made from the run's
    seed and the rank."""
    return (seed * 1_000_003 + 7919 * (rank + 1)) % 2**63


def _run_rank(local_rank: int, fn: Callable, args: tuple, init_method: str, world: int,
              first_rank: int, device_type: str):
    initialize(init_method, world, first_rank + local_rank,
               device=local_device(local_rank, device_type))
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _spawned_rank(local_rank: int, results, *run_args) -> None:
    out = _run_rank(local_rank, *run_args)
    if local_rank == 0:
        results.put(out)


def launch(fn: Callable, num_devices: int, args: tuple = (), device_type: str = "cuda",
           coordinator: Optional[str] = None, num_machines: int = 1, machine_rank: int = 0,
           rendezvous_dir: Optional[str] = None):
    """Run `fn(*args)` in `num_devices` ranks on this machine, local rank i
    on `cuda:i` (or all on the CPU), in a group of `num_machines *
    num_devices` ranks in which this machine's are `machine_rank *
    num_devices` onwards; returns what local rank 0's `fn` returned. `fn`
    must be importable by name (the ranks are spawned), and so must what it
    returns be picklable. With one local rank on one machine `fn` runs in
    this process. Without a `coordinator` (one machine only) the ranks meet
    through a file in a fresh directory under `rendezvous_dir` (default: the
    temporary directory), removed afterwards."""
    if num_devices < 1:
        raise ValueError(f"num_devices = {num_devices}")
    if device_type == "cuda" and num_devices > torch.cuda.device_count():
        raise ValueError(f"{num_devices} local ranks, {torch.cuda.device_count()} CUDA devices")
    tmp = None
    if coordinator is None:
        if num_machines > 1:
            raise ValueError("a launch over several machines needs a coordinator")
        tmp = tempfile.mkdtemp(prefix="combo_rendezvous_", dir=rendezvous_dir or None)
        coordinator = "file://" + os.path.join(tmp, "store")
    run_args = (fn, args, _init_method(coordinator), num_machines * num_devices,
                machine_rank * num_devices, device_type)
    try:
        if num_devices == 1:
            return _run_rank(0, *run_args)
        results = torch.multiprocessing.get_context("spawn").SimpleQueue()
        torch.multiprocessing.start_processes(_spawned_rank, args=(results, *run_args),
                                              nprocs=num_devices, join=True,
                                              start_method="spawn")
        return results.get() if not results.empty() else None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
