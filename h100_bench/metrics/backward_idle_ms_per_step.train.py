"""backward_idle_ms_per_step.train: device idle a step whose gaps'
middles fall inside `combo.backward`
(`h100_bench.spans.backward_idle_ms`)."""

from h100_bench.spans import backward_idle_ms as read  # noqa: F401
