"""The port's data-parallel pieces in one process (`parallel/`, the
criterion's global normalizers and draws, `TrainLoader`'s shards), with a
2-rank world injected: two threads of this process, whose sums over ranks
wait for each other (`ThreadWorld`). tests/test_torch_ddp.py runs two real
processes.

* `shard_records` covers every record once; `per_rank_batch` and
  `shard_batch` split the global batch evenly or refuse;
* `TrainLoader`'s shards are row slices of the one-shard loader's batches,
  with the same mapper draws;
* `all_sum_array` and `merge_evaluator_across_hosts` over 2 ranks, for the
  S4 and the AVSS evaluator, equal one pass over every video, and equal
  the JAX package's functions on the same numbers (its allgather faked);
* the criterion's losses on 2 ranks sum to the one-process losses, with
  the draws from the shared generator; each rank's rows of the global draws
  are the one-process draws' rows; the class loss's weight sum is the same
  for every decoder output's matching;
* the world of one changes nothing.
"""

import os
import threading

import numpy as np
import pytest
import torch

from jax.experimental import multihost_utils

import combo_avs_tpu.parallel.distributed as jax_distributed
from combo_avs_torch import config
from combo_avs_torch.data.catalogs import load_avss4_records
from combo_avs_torch.data.loader import TrainLoader
from combo_avs_torch.data.synth import make_s4
from combo_avs_torch.evaluation.evaluator import SemSegEvaluator, SemSegEvaluatorSS
from combo_avs_torch.losses.criterion import SetCriterion
from combo_avs_torch.losses.matcher import HungarianMatcher
from combo_avs_torch.parallel import distributed
from combo_avs_torch.parallel.mesh import (local_device, per_rank_batch, shard_batch,
                                           shard_records)
from combo_avs_torch.train.trainer import build_mapper
from tests.test_torch_config import S4
from tests.test_torch_losses import ISR, MPTS, NPTS, OS
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    one_torch_thread, release_worker_memory)
from tests.test_torch_trainer import TINY_RUN

LOSS_RTOL = 1e-12  # float64, the same sums split in two


class ThreadWorld(distributed.World):
    """Rank `rank` of `size` threads: `all_sum_` puts this rank's tensor in a
    shared slot, waits for every rank, and sums the slots in rank order."""

    def __init__(self, rank: int, shared: dict):
        super().__init__(rank, shared["size"])
        self.shared = shared
        self.calls = 0

    def all_sum_(self, t):
        self.calls += 1
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = t.detach().clone()
        barrier.wait()
        total = slots[0].clone()
        for s in slots[1:]:
            total += s
        barrier.wait()
        with torch.no_grad():
            t.copy_(total)
        return t

    def barrier(self):
        self.shared["barrier"].wait()

    def broadcast_(self, t):
        self.calls += 1
        slots, barrier = self.shared["slots"], self.shared["barrier"]
        slots[self.rank] = t.detach().clone()
        barrier.wait()
        theirs = slots[0].clone()
        barrier.wait()
        with torch.no_grad():
            t.copy_(theirs)


def run_ranks(size, fn):
    """[fn(world) for each rank], each rank in a thread of its own."""
    shared = {"size": size, "slots": [None] * size,
              "barrier": threading.Barrier(size, timeout=120)}
    out, errors = [None] * size, []

    def body(r):
        try:
            out[r] = fn(ThreadWorld(r, shared))
        except BaseException as e:  # noqa: BLE001 (raised below)
            errors.append(e)
            shared["barrier"].abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------- shards
@pytest.mark.parametrize("n", [0, 1, 5, 7])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_shard_records_cover_every_record_once(n, world):
    records = [{"video": i} for i in range(n)]
    shards = [shard_records(records, r, world) for r in range(world)]
    seen = sorted(rec["video"] for s in shards for rec in s)
    assert seen == list(range(n))
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    if world == 1:
        assert shards[0] is records


def test_batch_split_and_devices():
    assert per_rank_batch(8, 2) == 4 and per_rank_batch(8, 1) == 8
    for bad in ((8, 3), (1, 2), (8, 0)):
        with pytest.raises(ValueError, match="does not split"):
            per_rank_batch(*bad)
    batch = {"a": np.arange(8).reshape(4, 2), "b": np.arange(4)}
    parts = [shard_batch(batch, r, 2) for r in range(2)]
    for k in batch:
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), batch[k])
    with pytest.raises(ValueError):
        shard_batch(batch, 0, 3)
    assert local_device(3) == torch.device("cuda", 3)
    assert local_device(3, "cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def s4_records(tmp_path_factory):
    s4 = make_s4(str(tmp_path_factory.mktemp("dist_s4")), n_train=5, n_val=0, size=64)
    return load_avss4_records(s4, "train", os.path.join(s4, "pre_SAM_mask"))


def test_train_loader_shards_are_row_slices(s4_records):
    """Each of 2 shards of a global batch of 4 is the rows of the one-shard
    loader's batch at that place, the mapper's random transform included,
    over 3 batches (the 5 videos' permutations wrap within them); a shard
    count that does not divide the batch is refused."""
    cfg = config.setup_cfg(S4, TINY_RUN)
    mapper = build_mapper(cfg, is_train=True, seed=3)

    def batches(**kw):
        loader = TrainLoader(s4_records, mapper, batch_size=4, seed=3, num_workers=2, **kw)
        try:
            return [next(loader) for _ in range(3)]
        finally:
            loader.close()

    whole = batches()
    shards = [batches(shard_index=r, num_shards=2) for r in range(2)]
    for i, full in enumerate(whole):
        for r in range(2):
            for k, v in full.items():
                np.testing.assert_array_equal(shards[r][i][k], v[2 * r:2 * r + 2],
                                              err_msg=f"batch {i} shard {r} {k}")
    with pytest.raises(ValueError, match="does not split"):
        TrainLoader(s4_records, mapper, batch_size=3, num_shards=2)


# ---------------------------------------------------------------- evaluators
def _videos(kind, seed, n):
    rng = np.random.RandomState(seed)
    C = 2 if kind == "s4" else 6
    for _ in range(n):
        gt = rng.randint(0, C, (3, 8, 8))
        gt[:, 0, 0] = 255  # an ignored pixel
        yield rng.randn(3, C, 8, 8), gt


def _evaluator(kind):
    return SemSegEvaluator() if kind == "s4" else SemSegEvaluatorSS(num_classes=6)


ACCUMULATORS = {"s4": ("_miou_sum", "_f_sum", "_count"), "avss": ("_iou_pc", "_f_pc", "_cls_pc")}


@pytest.mark.parametrize("kind", ["s4", "avss"])
def test_evaluator_merge_equals_one_pass_and_jax(kind, monkeypatch):
    """Rank r processes its 3 (rank 0) or 2 (rank 1) videos; merged over the
    2 ranks, both evaluators hold one pass's sums and give its metrics; the
    JAX package's `merge_evaluator_across_hosts` and `all_sum_array` (its
    allgather answering with both ranks' values) give the same numbers."""
    per_rank = [list(_videos(kind, r, 3 - r)) for r in range(2)]
    full = _evaluator(kind)
    for videos in per_rank:
        for sem, gt in videos:
            full.process(sem, gt)

    def rank_evaluator(r):
        ev = _evaluator(kind)
        for sem, gt in per_rank[r]:
            ev.process(sem, gt)
        return ev

    merged = run_ranks(2, lambda world: distributed.merge_evaluator_across_hosts(
        rank_evaluator(world.rank), world))
    for ev in merged:
        assert ev.evaluate() == full.evaluate()
        for attr in ACCUMULATORS[kind]:
            np.testing.assert_allclose(getattr(ev, attr), getattr(full, attr), rtol=1e-15)
            assert type(getattr(ev, attr)) is type(getattr(full, attr))

    # the JAX functions on the same numbers: process_allgather gives each
    # accumulator of both ranks, in the order the merge asks for them
    locals_ = [rank_evaluator(r) for r in range(2)]
    for r in range(2):
        asked = iter(ACCUMULATORS[kind])

        def gather(x, asked=asked):
            name = next(asked)
            return np.stack([np.asarray(getattr(ev, name), np.float64) for ev in locals_])

        with monkeypatch.context() as m:
            m.setattr(jax_distributed.jax, "process_count", lambda: 2)
            m.setattr(multihost_utils, "process_allgather", gather)
            jev = jax_distributed.merge_evaluator_across_hosts(rank_evaluator(r))
        for attr in ACCUMULATORS[kind]:
            assert np.array_equal(getattr(jev, attr), getattr(merged[r], attr)), attr

    x = [np.arange(6, dtype=np.float64) * (r + 1) / 7 for r in range(2)]
    got = run_ranks(2, lambda world: distributed.all_sum_array(x[world.rank], world))
    monkeypatch.setattr(jax_distributed.jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda v: np.stack(x))
    want = jax_distributed.all_sum_array(x[0])
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_all_sum_tensors_buckets():
    """Tensors of two types summed over 2 ranks in place, in few flat
    buckets: consecutive tensors of one type share a bucket up to the cap."""
    def fn(world):
        g = torch.Generator().manual_seed(world.rank)
        ts = [torch.randn(n, generator=g, dtype=dt) for n, dt in (
            (10, torch.float32), (20, torch.float32), (5, torch.float64), (300, torch.float64),
            (7, torch.float64))]
        before = [t.clone() for t in ts]
        distributed.all_sum_tensors_(ts, world, bucket_bytes=1024)
        return before, ts, world.calls

    (b0, t0, calls), (b1, t1, _) = run_ranks(2, fn)
    for a, b, s, s1 in zip(b0, b1, t0, t1):
        torch.testing.assert_close(s, a + b, rtol=0, atol=0)
        torch.testing.assert_close(s1, s, rtol=0, atol=0)
    # [f32 x2], [f64 5], [f64 300] alone (2400 bytes over the cap), [f64 7]
    assert calls == 4


def test_broadcast_module_gives_every_rank_rank0s_weights():
    """Each rank builds its module from its own seed; after
    `broadcast_module_` every parameter and buffer is rank 0's, sent in one
    flat bucket a type."""
    def fn(world):
        torch.manual_seed(world.rank)
        m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
        m[1].running_mean.normal_()
        m[1].num_batches_tracked.fill_(world.rank + 5)
        distributed.broadcast_module_(m, world)
        return m.state_dict(), world.calls

    (s0, c0), (s1, c1) = run_ranks(2, fn)
    assert c0 == c1 == 2  # float32 tensors, then the int64 counter
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert int(s1["1.num_batches_tracked"]) == 5


# ---------------------------------------------------------------- criterion
B, T, K, Q, H = 4, 5, 3, 8, 16


def _problem(seed=0):
    """Outputs and targets of a 4-video batch whose halves hold 2 + 3 and
    6 + 9 valid masks and different frame weights, float64."""
    rng = np.random.RandomState(seed)
    N = B * T
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    layer = lambda: {"pred_logits": t(rng.randn(N, Q, 3)),  # noqa: E731
                     "pred_masks": t(rng.randn(N, Q, H, H))}
    outputs = {**layer(), "aux_outputs": [layer(), layer()],
               "middles_attn_mask": [t(rng.randn(N, Q, H * H)) for _ in range(2)]}
    valid = np.zeros((B, T, K), bool)
    valid[0, :2, 0] = True
    valid[1, :3, 0] = True
    valid[2, :3, :2] = True
    valid[3] = True
    fw = np.zeros((B, T))
    fw[:, 0] = 1.0
    fw[2:, 2] = 1.0
    targets = {"labels": t(rng.randint(0, 2, (N, K))), "valid": t(valid.reshape(N, K)),
               "masks": t((rng.rand(N, K, 4 * H, 4 * H) > 0.5).astype(np.float64))}
    return outputs, targets, t(fw.reshape(N))


def _rows(tree, r, n):
    """Rank r's frames (n each) of every tensor of an outputs/targets tree."""
    if isinstance(tree, dict):
        return {k: _rows(v, r, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, r, n) for v in tree]
    return tree[r * n:(r + 1) * n]


def _criterion():
    return SetCriterion(matcher=HungarianMatcher(num_points=MPTS), num_points=NPTS,
                        oversample_ratio=OS, importance_sample_ratio=ISR)


def test_criterion_global_normalizers_sum_to_one_process():
    """On 2 ranks (threads), each with its half of the batch and drawing from
    a generator seeded alike, the losses sum to the one-process losses on
    the whole batch within 1e-12 relative; each rank's own normalizers
    would miss them by far more; one sum over ranks serves the step."""
    outputs, targets, fw = _problem()
    crit = _criterion()
    want = crit(outputs, targets, fw, generator=torch.Generator().manual_seed(5),
                world=distributed.World())
    n = B * T // 2

    def rank(world):
        return crit(_rows(outputs, world.rank, n), _rows(targets, world.rank, n),
                    fw[world.rank * n:(world.rank + 1) * n],
                    generator=torch.Generator().manual_seed(5), world=world), world.calls

    (l0, c0), (l1, c1) = run_ranks(2, rank)
    assert c0 == c1 == 1 and set(l0) == set(want) and len(want) == 3 * 3 + 2
    for k, v in want.items():
        assert abs(float(l0[k] + l1[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k
    own = [crit(_rows(outputs, r, n), _rows(targets, r, n), fw[r * n:(r + 1) * n],
                generator=torch.Generator().manual_seed(5), world=distributed.World())
           for r in range(2)]
    assert max(abs(float(own[0][k] + own[1][k] - v)) / abs(float(v)) for k, v in want.items()
               if "cosine" not in k) > 0.1


def test_global_draws_sliced_per_rank_are_the_one_process_rows():
    crit = _criterion()
    N = 6
    want = crit.draw(torch.Generator().manual_seed(2), 3 * N, K)
    for r in range(3):
        got = crit.draw_shard(torch.Generator().manual_seed(2), N, K, distributed.World(r, 3))
        torch.testing.assert_close(got[0], want[0][r * N:(r + 1) * N], rtol=0, atol=0)
        for g, w_ in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w_[r * N * K:(r + 1) * N * K], rtol=0, atol=0)
            assert g.is_contiguous() and g.untyped_storage().nbytes() == g.nbytes


def test_class_weight_sum_serves_every_decoder_output():
    """The class loss with the weight sum `class_weight_sum` gives (valid
    slots and frame weights only) equals the loss with the sum of its own
    weights, for each of the 3 decoder outputs' matchings."""
    outputs, targets, fw = _problem(1)
    crit = _criterion()
    valid = targets["valid"] & (fw[:, None] > 0)
    total = crit.class_weight_sum(valid, fw, Q)
    layers = [outputs] + outputs["aux_outputs"]
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((B * T, MPTS, 2), generator=g, dtype=torch.float64)
    assigns = crit.matcher.match_layers(
        [(pts, lay["pred_logits"], lay["pred_masks"], targets["labels"], targets["masks"],
          valid) for lay in layers])
    assert len({tuple(a.reshape(-1).tolist()) for a in assigns}) > 1  # the matchings differ
    for lay, assign in zip(layers, assigns):
        own = crit._loss_labels(lay["pred_logits"], targets["labels"], valid, assign, fw)
        shared = crit._loss_labels(lay["pred_logits"], targets["labels"], valid, assign, fw,
                                   total)
        assert abs(float(own - shared)) <= 1e-15 * abs(float(own))


# ---------------------------------------------------------------- one rank
def test_world_of_one_is_a_no_op():
    one = distributed.World()
    assert one.main and one.size == 1 and distributed.current().size == 1
    t = torch.arange(4.0)
    assert one.all_sum_(t) is t and torch.equal(t, torch.arange(4.0))
    one.barrier()
    one.broadcast_(t)
    distributed.all_sum_tensors_([t], one)
    assert torch.equal(t, torch.arange(4.0))
    x = np.arange(3.0)
    assert distributed.all_sum_array(x) is x
    ev = SemSegEvaluator()
    ev.process(np.random.RandomState(0).randn(2, 2, 4, 4), np.ones((2, 4, 4), int))
    sums = (ev._miou_sum, ev._f_sum, ev._count)
    assert distributed.merge_evaluator_across_hosts(ev) is ev
    assert (ev._miou_sum, ev._f_sum, ev._count) == sums
    outputs, targets, fw = _problem(2)
    crit = _criterion()
    a = crit(outputs, targets, fw, generator=torch.Generator().manual_seed(1))
    b = crit(outputs, targets, fw, generator=torch.Generator().manual_seed(1), world=one)
    assert all(torch.equal(a[k], b[k]) for k in a)
