"""device_idle_pct.train: the share of the traced window in which no device operation runs
(`h100_bench.readers.idle_pct`)."""

from h100_bench.readers import idle_pct as read  # noqa: F401
