"""forward_device_ms_per_step.train: device time a step launched while
`combo.forward` or a span under it was the innermost open one
(`h100_bench.spans.forward_device_ms`)."""

from h100_bench.spans import forward_device_ms as read  # noqa: F401
