"""How `correct` is decided: the program's readings against the plain
reference's, each number against its limit.

Training: the first three steps of the very step object the window then
drives, on three different batches of the pool, with the benchmark's
criterion draws and a dropout generator seeded alike on both sides. Each
step's total loss; the first gradient as AdamW received it (from its state
after one step), per parameter; each parameter's change after three steps.
Gaps are of norms, per parameter, against the larger of the reference's
norm of that parameter and of the median parameter's; parameters whose
reference gradient is under a thousandth of the median's are left out of
the change (round-off alone moves them under Adam).

Evaluation: the semantic maps of sampled window steps against the
reference's forward on the same batch in float32 with TF32 off.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

CHANGE_FLOOR = 1e-3  # of the median parameter's reference gradient
# the losses of the first decoder output, made ahead of any masked
# attention: the queries and the mask features alone
FIRST_OUTPUT = ("loss_ce_0", "loss_mask_0", "loss_dice_0", "loss_cosine_0")


def tf32_flags() -> Dict[str, bool]:
    return {"matmul_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_tf32": bool(torch.backends.cudnn.allow_tf32)}


class tf32_as:
    """The TF32 flags set as `flags` says, restored on exit."""

    def __init__(self, flags: Dict[str, bool]):
        self.flags = flags

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.flags["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = self.flags["cudnn_tf32"]

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def _gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Dict[str, float]:
    """Per parameter, |prog - ref| against the larger of the reference's
    norm and the median parameter's; inf for a parameter with no reading."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) if n in prog else float("inf")
            for n in names}


def train_numbers(prog: Dict, ref: Dict) -> Dict:
    """The compared numbers of a training cell: the largest loss gap over
    the steps and the first step's, the worst and the median parameter's
    gradient gap, the worst and the median parameter's change gap; the
    worst parameters' names beside them."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": float("inf")}
    loss = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [n for n in names if ref["grad"][n] >= CHANGE_FLOOR * med]
    grad, change = _gaps(prog["grad"], ref["grad"], names), _gaps(prog["change"], ref["change"],
                                                                   moved)
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    terms = {k: abs(prog["terms"].get(k, float("inf")) - r) / max(abs(r), 1e-30)
             for k, r in ref["terms"].items()}
    first = [terms[k] for k in FIRST_OUTPUT if k in terms]
    return {"loss_gap": max(loss), "loss1_gap": loss[0],
            "first_output_gap": max(first) if first else float("inf"),
            "terms_median_gap": statistics.median(terms.values()),
            "grad_gap": grad[worst_g], "grad_median_gap": statistics.median(grad.values()),
            "grad_ratio_spread": ratio_spread(prog["grad"], ref["grad"], names),
            "change_gap": change[worst_c], "change_median_gap": statistics.median(change.values()),
            "change_ratio_spread": ratio_spread(prog["change"], ref["change"], moved),
            "worst": {"grad": worst_g, "change": worst_c}, "left_out": len(names) - len(moved),
            "losses": {"program": prog["losses"], "reference": ref["losses"]}}


def ratio_spread(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    """The median absolute deviation of the per-parameter norm ratios
    (program over reference) about their median, over that median: how
    far the parameters disagree with each other, whatever scale all of them
    share (the full-model clip scales every gradient alike)."""
    ratios = [prog.get(n, float("inf")) / ref[n] for n in names if ref[n] > 0]
    if not ratios:
        return float("inf")
    m = statistics.median(ratios)
    return statistics.median(abs(r - m) for r in ratios) / m if m > 0 else float("inf")


def eval_numbers(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> Dict:
    """The maps' relative L2 gap over each compared step (the largest), and
    over each frame (the largest)."""
    if len(prog) != len(ref) or not prog:
        return {"sem_gap": float("inf"), "sem_frame_gap": float("inf"),
                "sem_frame_median_gap": float("inf"), "frame_gaps": []}
    step, frames = [], []
    for p, r in zip(prog, ref):
        d, r = (p.double() - r.double()).flatten(1), r.double().flatten(1)
        step.append(float(d.norm() / r.norm()))
        frames += (d.norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)).tolist()
    return {"sem_gap": max(step), "sem_frame_gap": max(frames),
            "sem_frame_median_gap": statistics.median(frames), "frame_gaps": frames}


def judge(numbers: Dict, limits: Dict, flags: Dict) -> Dict:
    """{name: [number, limit]} of every compared number, and whether all
    hold: each number at most its limit, and the TF32 flags as the
    configuration states them after set-up and at the window's end."""
    table = {k: [numbers.get(k, float("inf")), limits[k]] for k in limits}
    ok = all(v == v and v <= lim for v, lim in table.values())
    for when, got in flags["seen"].items():
        for k, want in flags["want"].items():
            table[f"{k}_{when}"] = [int(got[k]), int(want)]
            ok = ok and got[k] == want
    return {"correct": bool(ok), "table": table}
