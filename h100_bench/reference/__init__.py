"""The plain reference: plain PyTorch, NumPy and SciPy, nothing of the program."""
