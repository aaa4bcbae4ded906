"""criterion_idle_ms_per_step.train: device idle a step whose gaps'
middles fall inside `combo.criterion` or a span under it
(`h100_bench.spans.criterion_idle_ms`)."""

from h100_bench.spans import criterion_idle_ms as read  # noqa: F401
