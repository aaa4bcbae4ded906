"""Data parallelism: one process per device, joined by `torch.distributed`."""
