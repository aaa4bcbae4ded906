"""Exact linear sum assignment, batched on the device.

Port of `combo_avs_tpu/ops/lsap.py` (`solve_lsap_small`, `solve_lsap`,
`solve_lsap_batch`), behind the same dispatch: up to SMALL_R_MAX rows the
closed form, above it the Jonker-Volgenant solver. The sums run in float32,
as in the JAX package.

* Closed form (the S4 and MS3 matcher: R = 3 padded target slots,
  `combo_avs_tpu/train/trainer.py:60`): an optimal assignment uses, for each
  row, one of that row's R cheapest columns (exchange argument in the JAX
  module's docstring), so the solver takes each row's top-R columns with
  `torch.topk`, enumerates all R^R choices, masks the ones that reuse a
  column and keeps the cheapest.
* Jonker-Volgenant (AVSS: R = 12 slots): scipy's shortest augmenting path
  (Crouse 2016), rows assigned one by one, each by a Dijkstra search over
  columns whose path traverses assigned columns only. Row r (counting from
  0) finds a free column within r + 1 search steps (r columns are assigned)
  and augments along at most r + 1 swaps, so fixed trip counts with a
  per-matrix `done` mask replace the JAX solver's `lax.while_loop`s: every
  matrix of the batch runs the same torch ops and nothing waits on the
  host. A finished matrix's state is kept by `torch.where`, so each
  matrix's arithmetic is the JAX solver's, step for step. Ties go as there:
  the search prefers an unassigned column on an exact tie by nudging every
  assigned column up by the spacing of its own magnitude, a nudge XLA's
  CPU backend drops where it is subnormal (it flushes subnormals), so this
  one does too; `argmin` then takes the first of equal values in both
  packages.
"""

from __future__ import annotations

import itertools

import torch

SMALL_R_MAX = 5  # 5^5 = 3125 candidate tuples; the JAX package's _SMALL_R_MAX


def solve_lsap_small(cost: torch.Tensor) -> torch.Tensor:
    """cost [N, R, C] with R <= C -> [N, R] int64, by enumerating each row's R
    cheapest columns (R <= SMALL_R_MAX)."""
    N, R, C = cost.shape
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


def solve_lsap_jv(cost: torch.Tensor) -> torch.Tensor:
    """cost [N, R, C] with R <= C -> [N, R] int64 by the shortest augmenting
    path, every matrix of the batch at once (`combo_avs_tpu/ops/lsap.py::
    solve_lsap`, vmapped there)."""
    N, R, C = cost.shape
    dev = cost.device
    cost = cost.to(torch.float32)
    n = torch.arange(N, device=dev)
    inf = torch.tensor(torch.inf, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.zeros((N, R), device=dev)
    v = torch.zeros((N, C), device=dev)
    row4col = torch.full((N, C), -1, dtype=torch.long, device=dev)
    col4row = torch.full((N, R), -1, dtype=torch.long, device=dev)
    for cur in range(R):
        # Dijkstra over columns from row `cur`; `sink` is the free column found
        sink = torch.full((N,), -1, dtype=torch.long, device=dev)
        i = torch.full((N,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros((N,), device=dev)
        spc = torch.full((N, C), torch.inf, device=dev)
        path = torch.full((N, C), -1, dtype=torch.long, device=dev)
        sc = torch.zeros((N, C), dtype=torch.bool, device=dev)
        sr = torch.zeros((N, R), dtype=torch.bool, device=dev)
        for _ in range(cur + 1):
            active = sink < 0
            sr[n, i] = sr[n, i] | active
            r = min_val[:, None] + cost[n, i] - u[n, i][:, None] - v
            better = ~sc & (r < spc) & active[:, None]
            spc = torch.where(better, r, spc)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(sc, inf, spc)
            finite = torch.where(torch.isfinite(masked), masked.abs(), 0.0)
            spacing = torch.nextafter(finite, inf) - finite
            nudge = torch.where((row4col >= 0) & (spacing >= tiny), spacing, 0.0)
            j = torch.argmin(masked + nudge, dim=1)
            min_val = torch.where(active, masked[n, j], min_val)
            sc[n, j] = sc[n, j] | active
            owner = row4col[n, j]
            free = owner < 0
            sink = torch.where(active & free, j, sink)
            i = torch.where(active & ~free, owner, i)
        # dual updates (scipy's _lsap.c)
        u[:, cur] = u[:, cur] + min_val
        other = sr.clone()
        other[:, cur] = False
        spc_row = spc.gather(1, col4row.clamp(0, C - 1))
        u = torch.where(other, u + min_val[:, None] - spc_row, u)
        v = torch.where(sc, v - (min_val[:, None] - spc), v)
        # augment along the alternating path back to row `cur`
        j = sink
        done = torch.zeros((N,), dtype=torch.bool, device=dev)
        for _ in range(cur + 1):
            act = ~done
            jj = j.clamp(min=0)
            i = path[n, jj]
            ii = i.clamp(min=0)
            row4col[n, jj] = torch.where(act, i, row4col[n, jj])
            prev = col4row[n, ii]
            col4row[n, ii] = torch.where(act, jj, col4row[n, ii])
            done = done | (i == cur)
            j = prev
    return col4row


def solve_lsap_batch(cost: torch.Tensor) -> torch.Tensor:
    """cost [N, R, C] with R <= C -> [N, R] int64: the column assigned to each
    row in a minimum-total-cost assignment of every row; the closed form up
    to SMALL_R_MAX rows, Jonker-Volgenant above."""
    N, R, C = cost.shape
    if R > C:
        raise ValueError(f"solve_lsap_batch expects R <= C, got cost {tuple(cost.shape)}")
    return solve_lsap_small(cost) if R <= SMALL_R_MAX else solve_lsap_jv(cost)
