"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): the yardstick of every roofline and MFU share."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def step_peak(precision: dict) -> float:
    """The fastest arithmetic a cell's precision admits: bf16 where the
    forward runs in bf16, TF32 where cuDNN or cuBLAS may use it, fp32
    otherwise."""
    if precision["dtype"] == "bfloat16":
        return FLOPS_PER_S["bfloat16"]
    if precision["matmul_tf32"] or precision["cudnn_tf32"]:
        return FLOPS_PER_S["tf32"]
    return FLOPS_PER_S["float32"]
