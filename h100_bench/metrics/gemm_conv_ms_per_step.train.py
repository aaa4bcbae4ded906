"""gemm_conv_ms_per_step.train: device time of GEMM and convolution kernels a step
(`h100_bench.readers.gemm_conv_ms_per_step`)."""

from h100_bench.readers import gemm_conv_ms_per_step as read  # noqa: F401
