"""Image files by their content: `read_image(path, gray=False)` reads a PNG
(`data/png.py`) or a JPEG (`data/jpeg.py`), chosen by the magic bytes as the
JAX package's native reader chooses (`combo_avs_tpu/native/combo_io.cpp::
decode_file`: the PNG signature, or FF D8), whatever the file's extension.
Either returns uint8 [H, W, 3] RGB, or [H, W] with gray=True; any other
format raises `ValueError`.
"""

from __future__ import annotations

import numpy as np

from combo_avs_torch.data.jpeg import decode_jpeg
from combo_avs_torch.data.png import decode_png

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"


def read_image(path: str, gray: bool = False) -> np.ndarray:
    """The PNG or JPEG at `path` -> uint8 [H, W, 3] RGB, or [H, W] with
    gray=True."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_MAGIC):
        return decode_png(data, gray=gray, name=path)
    if data.startswith(JPEG_MAGIC):
        return decode_jpeg(data, gray=gray, name=path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (only those are decoded)")
