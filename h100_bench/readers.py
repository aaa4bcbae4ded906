"""The reductions the per-layer metric files (`metrics/<name>.py`) share.
Each takes the traced run's context and returns the metric, or None where
the trace holds nothing to read (never 0 for a share of a peak)."""

from __future__ import annotations

from typing import Dict, Optional


def idle_pct(ctx: Dict) -> Optional[float]:
    t = ctx["trace"]
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(ctx: Dict) -> Optional[float]:
    t = ctx["trace"]
    if not t.get("window_s") or not ctx["flops_per_step"]:
        return None
    return 100.0 * ctx["flops_per_step"] * t["steps"] / (t["window_s"] * ctx["peak_flops"])


def port_roofline_pct(ctx: Dict) -> Optional[float]:
    device_s = sum(ctx["trace"].get("by_port_op_s", {}).values())
    bound_s = sum(c[3] for c in ctx["calls"])
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def _ms_per_step(ctx: Dict, seconds: float) -> Optional[float]:
    if seconds <= 0:
        return None
    return 1e3 * seconds / ctx["trace"]["steps"]


def port_ms_per_step(ctx: Dict) -> Optional[float]:
    return _ms_per_step(ctx, sum(ctx["trace"].get("by_port_op_s", {}).values()))


def gemm_conv_ms_per_step(ctx: Dict) -> Optional[float]:
    return _ms_per_step(ctx, ctx["trace"].get("by_category_s", {}).get("gemm_conv", 0.0))


def allreduce_ms_per_step(ctx: Dict) -> Optional[float]:
    return _ms_per_step(ctx, ctx["trace"].get("by_category_s", {}).get("allreduce", 0.0))


def launches_per_step(ctx: Dict) -> Optional[float]:
    t = ctx["trace"]
    return t["kernels"] / t["steps"] if t.get("kernels") else None
