"""optimizer_idle_ms_per_step.train: device idle a step whose gaps'
middles fall inside `combo.optim.clip` or `combo.optim.update`
(`h100_bench.spans.optimizer_idle_ms`)."""

from h100_bench.spans import optimizer_idle_ms as read  # noqa: F401
