"""Exact linear sum assignment for a few rows, batched on the device.

Port of `combo_avs_tpu/ops/lsap.py::solve_lsap_small` / `solve_lsap_batch`
for the row counts the S4 and MS3 matcher uses (R = 3 padded target slots,
`combo_avs_tpu/train/trainer.py:60`): an optimal assignment uses, for each
row, one of that row's R cheapest columns (exchange argument in the JAX
module's docstring), so the solver takes each row's top-R columns with
`torch.topk`, enumerates all R^R choices, masks the ones that reuse a column
and keeps the cheapest. The sums run in float32, as in the JAX package.

More than 5 rows (AVSS, 12 slots) needs the Jonker-Volgenant solver
(`solve_lsap` in the JAX package), which is not ported yet.
"""

from __future__ import annotations

import itertools

import torch

SMALL_R_MAX = 5  # 5^5 = 3125 candidate tuples; the JAX package's _SMALL_R_MAX


def solve_lsap_batch(cost: torch.Tensor) -> torch.Tensor:
    """cost [N, R, C] with R <= C -> [N, R] int64: the column assigned to each
    row in a minimum-total-cost assignment of every row."""
    N, R, C = cost.shape
    if R > C:
        raise ValueError(f"solve_lsap_batch expects R <= C, got cost {tuple(cost.shape)}")
    if R > SMALL_R_MAX:
        raise NotImplementedError(
            f"solve_lsap_batch: {R} rows; above {SMALL_R_MAX} the Jonker-Volgenant solver "
            "is needed, which is not ported yet")
    cost = cost.to(torch.float32)
    neg_top, top_cols = torch.topk(-cost, R, dim=-1)  # per row, its R cheapest columns
    top_cost = -neg_top  # [N, R, R]
    combos = torch.tensor(list(itertools.product(range(R), repeat=R)), device=cost.device)
    rows = torch.arange(R, device=cost.device)[None, :]
    cand_cols = top_cols[:, rows, combos]  # [N, R^R, R]
    total = top_cost[:, rows, combos].sum(-1)  # [N, R^R]
    distinct = torch.ones(combos.shape[0], dtype=torch.bool, device=cost.device)
    for a in range(R):
        for b in range(a + 1, R):
            distinct = distinct & (cand_cols[:, :, a] != cand_cols[:, :, b])
    best = torch.where(distinct, total, torch.inf).argmin(-1)  # [N]
    return cand_cols[torch.arange(N, device=cost.device), best]
