"""Offline data-preparation tools: `python -m combo_avs_torch.tools.<name>`."""
