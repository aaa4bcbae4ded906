"""The port's hand-written kernels (K1-K7): how their device time is found
in a trace (kernel names), and each call's bytes and operations from its
shapes (a frozen copy of the arithmetic `chip_smoke.py` bounds them with).

Bytes: every tensor the call takes and every tensor it returns, each read
or written once. Operations (fp32, on CUDA cores): K1 2*D per corner of
each sampling point, K2 10*D, K3/K5 and K4's image gradient 2*C, K4's
point gradient 14*C per point, K6 none, K7 12 + 2*C per (output pixel,
query). K1 and K2 count all four corners of every point, in or out of its
level, which is an upper count; at the shapes measured their bound is set
by bytes either way (K2 in fp32: 221 MB at 3.35 TB/s, 0.066 ms, against
0.076 ms for the operations at four corners, 0.066 ms at 87% inside).

The calls are recorded by wrapping the ops modules' launch functions for
the traced window only (`Recorder`): where a function is gone, nothing is
recorded and the kernels' metrics stay silent.
"""

from __future__ import annotations

import importlib
import re
from typing import Callable, Dict, List

import torch

from h100_bench.counts.peaks import FLOPS_PER_S, HBM_BYTES_PER_S


def _k1(args, out):
    value, attw = args[0], args[3]
    return 2 * value.shape[3] * 4 * attw.numel()


def _k2(args, out):
    value, attw = args[0], args[3]
    return 10 * value.shape[3] * 4 * attw.numel()


def _k3(args, out):
    feat, pts = args[0], args[1]
    return 2 * feat.shape[3] * 4 * pts.shape[0] * pts.shape[1]


def _k4_dimg(args, out):
    g = args[1]  # [N, P, C]
    return 2 * g.shape[2] * 4 * g.shape[0] * g.shape[1]


def _k4_dxy(args, out):
    feat, pts = args[0], args[1]
    return 14 * feat.shape[3] * pts.shape[0] * pts.shape[1]


def _k7(args, out):
    cls, size = args[0], args[2]
    N, Q, C = cls.shape
    return N * size[0] * size[1] * Q * (12 + 2 * C)


# op -> (module, launch function, operations, kernel name stems)
OPS: Dict[str, tuple] = {
    "k1_deform_fwd": ("combo_avs_torch.ops.deform_attn_cuda", "ms_deform_attn_cuda", _k1,
                      ("ms_deform_attn_fwd",)),
    "k2_deform_bwd": ("combo_avs_torch.ops.deform_attn_cuda", "ms_deform_attn_bwd_cuda", _k2,
                      ("ms_deform_attn_bwd",)),
    "k3_k5_point_fwd": ("combo_avs_torch.ops.point_sample_cuda", "point_sample_fwd_cuda", _k3,
                        ("point_sample_fwd",)),
    "k4_point_dimg": ("combo_avs_torch.ops.point_sample_cuda", "point_sample_dimg_cuda",
                      _k4_dimg, ("point_sample_dimg",)),
    "k4_point_dxy": ("combo_avs_torch.ops.point_sample_cuda", "point_sample_dxy_cuda", _k4_dxy,
                     ("point_sample_dxy",)),
    "k6_gather": ("combo_avs_torch.ops.gather_cuda", "gather_points_cuda",
                  lambda args, out: 0, ("gather_kernel",)),
    "k7_seminf": ("combo_avs_torch.ops.seminf_cuda", "seminf_cuda", _k7,
                  ("seminf_kernel", "seminf_patch_kernel")),
}

# a demangled name ("void ms_deform_attn_fwd_staged<float>(...)") or a
# mangled one ("_Z25ms_deform_attn_fwd_stagedIfEv...")
_PATTERNS = {op: re.compile(r"(?<![A-Za-z_])(" + "|".join(stems) + r")")
             for op, (_, _, _, stems) in OPS.items()}
GEMM_CONV = re.compile(r"gemm|xmma|cutlass|cudnn|conv|nvjet|wgrad|dgrad|fprop|winograd|"
                       r"implicit|sm90_|sm80_|ampere_", re.IGNORECASE)


def port_op(kernel: str):
    """The port op whose kernel this is, or None (PyTorch's own kernels,
    under at::native, never)."""
    if "at::native" in kernel or "at6native" in kernel:
        return None
    for op, pat in _PATTERNS.items():
        if pat.search(kernel):
            return op
    return None


def category(kernel: str) -> str:
    """port_kernels, allreduce (NCCL), gemm_conv or other."""
    if port_op(kernel):
        return "port_kernels"
    if "nccl" in kernel.lower():
        return "allreduce"
    if GEMM_CONV.search(kernel):
        return "gemm_conv"
    return "other"


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def call_bound(op: str, args, kwargs, out) -> Dict[str, float]:
    nbytes = sum(t.numel() * t.element_size()
                 for t in _tensors(args) + _tensors(kwargs) + _tensors(out))
    flops = OPS[op][2](args, out)
    return {"bytes": nbytes, "flops": flops,
            "bound_s": max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S["float32"])}


class Recorder:
    """Wraps each port op's launch function while active; `calls` holds
    (op, bytes, flops, bound seconds) of every call."""

    def __init__(self):
        self.calls: List[tuple] = []
        self._saved: List[tuple] = []

    def _wrap(self, op: str, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            b = call_bound(op, args, kwargs, out)
            self.calls.append((op, b["bytes"], b["flops"], b["bound_s"]))
            return out
        return wrapped

    def __enter__(self):
        for op, (module, name, _, _) in OPS.items():
            try:
                mod = importlib.import_module(module)
            except ImportError:
                continue
            fn = getattr(mod, name, None)
            if fn is not None:
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(op, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()
