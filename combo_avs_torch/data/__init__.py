"""Host-side data path: PNG codec, S4 catalog, eval mapper and loader, and
the synthetic S4 tree."""
