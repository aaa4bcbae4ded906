"""forward_idle_ms_per_step.train: device idle a step whose gaps'
middles fall inside `combo.forward` or a span under it
(`h100_bench.spans.forward_idle_ms`)."""

from h100_bench.spans import forward_idle_ms as read  # noqa: F401
