"""criterion_device_ms_per_step.train: device time a step launched while
`combo.criterion` or a span under it was the innermost open one
(`h100_bench.spans.criterion_device_ms`)."""

from h100_bench.spans import criterion_device_ms as read  # noqa: F401
