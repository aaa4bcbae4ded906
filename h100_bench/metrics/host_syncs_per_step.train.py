"""host_syncs_per_step.train: synchronizing CUDA operations the
program counted under the window's steps' spans, a step
(`h100_bench.spans.host_syncs_per_step`)."""

from h100_bench.spans import host_syncs_per_step as read  # noqa: F401
