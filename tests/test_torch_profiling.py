"""The port's spans and host-sync counter (`combo_avs_torch/utils/
profiling.py`) on the CPU: off they record nothing; on they leave the
train step's results bit for bit as they were and record its span tree;
the counter counts under the innermost span and restores the warning
filters. `tests/test_torch_ddp.py::test_profiling_on_the_cpu` holds the
spans in `trace()`'s Chrome trace to the profiler's clock."""

import copy
import warnings

import torch
from torch.profiler import ProfilerActivity

from combo_avs_torch.losses.criterion import build_weight_dict
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.train.optim import Optimizer
from combo_avs_torch.train.train_step import make_train_step
from combo_avs_torch.utils import profiling
from tests.test_torch_slice import (  # noqa: F401 (autouse fixtures)
    one_torch_thread, release_worker_memory)
from tests.test_torch_train import _batch, _criterion, _fields

# name -> parent of the train step's spans (tiny flagship: late fusion)
TREE = {
    "combo.step": None,
    "combo.forward": "combo.step",
    "combo.forward.audio": "combo.forward",
    "combo.forward.towers": "combo.forward",
    "combo.forward.pixel_decoder": "combo.forward",
    "combo.forward.fusion": "combo.forward",
    "combo.forward.predictor": "combo.forward",
    "combo.criterion": "combo.step",
    "combo.criterion.match_cost": "combo.criterion",
    "combo.criterion.lsap": "combo.criterion",
    "combo.criterion.losses": "combo.criterion",
    "combo.criterion.points": "combo.criterion.losses",
    "combo.backward": "combo.step",
    "combo.optim.clip": "combo.step",
    "combo.optim.update": "combo.step",
}


def test_spans_off_record_nothing():
    """Off, a span is the one shared no-op context and nothing is recorded;
    a step span under a profiler session records into `take_profiled()`."""
    assert profiling.span("combo.forward") is profiling.span("combo.step")
    assert profiling.step_span("combo.step") is profiling.span("combo.step")
    with profiling.step_span("combo.step"), profiling.span("combo.forward"):
        pass
    assert profiling.take_profiled().spans == []
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        with profiling.step_span("combo.step"), profiling.span("combo.forward"):
            pass
    with profiling.step_span("combo.step"):
        pass
    assert [s["name"] for s in profiling.take_profiled().spans] == ["combo.step",
                                                                     "combo.forward"]


def _step(model, record: bool):
    _, fields = _fields()
    wd = build_weight_dict(dec_layers=fields["dec_layers"] + 1)
    step = make_train_step(model, _criterion(), wd, Optimizer(model),
                           torch.Generator().manual_seed(0))
    batch = _batch(1, masks_dtype=bool)
    if not record:
        return step(batch), None
    with profiling.recording() as rec:
        metrics = step(batch)
    return metrics, rec


def test_train_step_is_the_same_with_spans_on_and_records_its_tree():
    """One step of the tiny flagship with spans off and on, from the same
    weights: bit-identical metrics and parameters; with spans on, the tree
    `TREE`, each phase once and the point selection once per decoder
    output."""
    _, fields = _fields()
    off = init_weights(MaskFormer(**fields, device="cpu"), seed=1)
    on = copy.deepcopy(off)
    m_off, _ = _step(off, record=False)
    m_on, rec = _step(on, record=True)
    assert m_on.keys() == m_off.keys()
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    for (name, a), b in zip(off.named_parameters(), on.parameters()):
        assert torch.equal(a, b), name
    spans = rec.spans
    assert {s["name"] for s in spans} == set(TREE)
    for s in spans:
        parent = None if s["parent"] is None else spans[s["parent"]]["name"]
        assert parent == TREE[s["name"]], s["name"]
        assert s["start_ns"] <= s["end_ns"] and s["syncs"] == 0
        if parent is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    counts = {n: sum(s["name"] == n for s in spans) for n in TREE}
    assert counts.pop("combo.criterion.points") == fields["dec_layers"] + 1
    assert set(counts.values()) == {1}
    assert rec.to_json()["total_syncs"] == 0
    assert not torch.cuda.is_initialized()


def test_sync_counter_counts_under_the_innermost_span():
    """A planted sync warning counts under the innermost open span, other
    warnings are shown as before, and the filters and `showwarning` are
    restored when the outermost span closes; no CUDA state is touched."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        filters, show = list(warnings.filters), warnings.showwarning
        with profiling.recording() as rec:
            with profiling.span("combo.step"):
                warnings.warn(profiling.SYNC_WARNING)
                with profiling.span("combo.criterion"):
                    for _ in range(2):
                        warnings.warn(f"{profiling.SYNC_WARNING} (Triggered internally)")
                    warnings.warn("another warning")
            assert warnings.filters == filters and warnings.showwarning is show
            warnings.warn(profiling.SYNC_WARNING)  # no span open: shown, not counted
    assert rec.syncs() == {"combo.step": 1, "combo.criterion": 2}
    assert [str(w.message) for w in shown] == ["another warning", profiling.SYNC_WARNING]
    assert not torch.cuda.is_initialized()
