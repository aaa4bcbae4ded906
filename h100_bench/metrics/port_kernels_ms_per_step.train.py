"""port_kernels_ms_per_step.train: device time of the port's kernels (K1-K7) a step
(`h100_bench.readers.port_ms_per_step`)."""

from h100_bench.readers import port_ms_per_step as read  # noqa: F401
