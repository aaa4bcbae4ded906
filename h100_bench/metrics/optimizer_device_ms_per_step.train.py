"""optimizer_device_ms_per_step.train: device time a step launched while
`combo.optim.clip` or `combo.optim.update` was open
(`h100_bench.spans.optimizer_device_ms`)."""

from h100_bench.spans import optimizer_device_ms as read  # noqa: F401
