"""mfu.train: model FLOPs of the steps over the traced window at the precision's peak
(`h100_bench.readers.mfu_pct`)."""

from h100_bench.readers import mfu_pct as read  # noqa: F401
