"""A cell of the benchmark cut to a size the CPU runs in seconds: 2 videos
of 5 frames at 64^2, 5 queries, 3 decoder outputs, 1 encoder layer, 256
points (exact top-k, which the port takes on the CPU), PVT depths 1/1/2/1;
the towers' widths stay. For the CPU tests only."""

from __future__ import annotations

import copy

from h100_bench import spec
from h100_bench.reference import model as ref_model

OPTS = ["MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", 5, "MODEL.MASK_FORMER.DEC_LAYERS", 3,
        "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", 1, "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", 256,
        "MODEL.MASK_FORMER.EXACT_TOPK_POINTS", True]
PVT_DEPTHS = (1, 1, 2, 1)


# an evaluation cell of the PVT configuration (bf16, the eval YAML); no
# evaluation cell is in BENCHMARK.json yet, the harness runs one all the same
EVAL = {"config": "combo_pvtv2b5_ms3", "mode": "eval", "chips": 1,
        "traffic": {"videos": 32, "frames": 5, "size": 224, "pool": 4, "out_size": [224, 224]},
        "sample_rounds": 2, "checked_steps": 0, "trace_steps": 8,
        "limits": {"sem_gap": 1.0}}


def cell(name: str, monkeypatch=None, limits=None, root: str = spec.ROOT) -> dict:
    """The cell `name` of BENCHMARK.json cut to the tiny size; "eval" is
    the evaluation cell `EVAL`."""
    if name == "eval":
        c = copy.deepcopy(spec.cell("pvt_ms3_train", root=root))
        c["workload"] = copy.deepcopy(EVAL)
        c["entry"] = dict(c["entry"], name="eval")
    else:
        c = copy.deepcopy(spec.cell(name, root=root))
    conf, w = c["config"], c["workload"]
    conf["opts"] = list(OPTS)
    conf["model"].update(num_queries=5, dec_layers=3, enc_layers=1)
    conf["criterion"].update(num_points=256, matcher_points=256, dec_layers=3, exact_topk=True)
    if conf["model"]["backbone"] == "pvt":
        conf["model"]["pvt_depths"] = list(PVT_DEPTHS)
        import combo_avs_torch.models.meta_arch as meta_arch

        monkeypatch.setattr(meta_arch, "PVT_DEPTHS", PVT_DEPTHS)
    conf["parameters"] = sum(p.numel() for p in ref_model.build(conf["model"], "meta").parameters())
    w["traffic"].update(videos=2, size=64, pool=3)
    if "out_size" in w["traffic"]:
        w["traffic"]["out_size"] = [64, 64]
    w["trace_steps"] = 2
    if limits is not None:
        w["limits"] = limits
    return c
