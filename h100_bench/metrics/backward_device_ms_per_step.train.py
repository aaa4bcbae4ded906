"""backward_device_ms_per_step.train: device time a step launched while
`combo.backward` was open
(`h100_bench.spans.backward_device_ms`)."""

from h100_bench.spans import backward_device_ms as read  # noqa: F401
