"""port_kernels_roofline_pct.train: the port ops' bound time over their kernels' device time
(`h100_bench.readers.port_roofline_pct`)."""

from h100_bench.readers import port_roofline_pct as read  # noqa: F401
