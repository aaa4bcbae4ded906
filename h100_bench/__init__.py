"""The benchmark of the PyTorch port on the H100 (`python3 -m h100_bench.run`)."""
