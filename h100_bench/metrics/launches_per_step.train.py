"""launches_per_step.train: kernels launched a step (`h100_bench.readers.launches_per_step`)."""

from h100_bench.readers import launches_per_step as read  # noqa: F401
