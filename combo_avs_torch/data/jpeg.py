"""JPEG decoding and encoding through the port's host C codec,
`combo_avs_torch/native/jpeg.c` (built with the host C compiler on first
use, `ops/_build.py::load_host`), in place of cv2 and the JAX package's
libjpeg reader (`combo_avs_tpu/native/combo_io.cpp::decode_jpeg`).

`read_jpeg(path, gray=False)` returns uint8 [H, W, 3] RGB, or [H, W] with
gray=True, equal byte for byte to what libjpeg gives with its default
settings (cv2.imread converted to RGB, and the JAX native reader): baseline,
extended-sequential and progressive Huffman JPEG, gray or YCbCr, any
integer sampling ratio, restart intervals. A gray read of a colour file is
its Y plane. EXIF orientation is not applied. Arithmetic coding, 12-bit
samples, lossless and hierarchical frames, CMYK/YCCK, RGB (Adobe transform
0), a DNL height and a progressive file with unrefined low AC coefficients
raise `ValueError` naming what the file uses, as do corrupt files.

`write_jpeg(path, img, quality=95, subsampling="420")` writes uint8 [H, W]
gray or [H, W, 3] RGB as baseline JPEG (YCbCr at 4:2:0 or 4:4:4), as
libjpeg's defaults write it.

The C calls go through ctypes, which releases the GIL for their duration, so
the loaders' mapper threads decode in parallel. Buffers are numpy arrays
owned here.
"""

from __future__ import annotations

import ctypes

import numpy as np

from combo_avs_torch.ops import _build

SOURCE = "native/jpeg.c"
SUBSAMPLING = {"420": 1, "444": 0}
_ERRLEN = 256
_lib = None


def _codec() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_host(SOURCE)
        lib.combo_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        *[ctypes.POINTER(ctypes.c_int)] * 3,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.combo_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                          ctypes.c_size_t]
        lib.combo_jpeg_encode.argtypes = [ctypes.c_void_p, *[ctypes.c_int] * 5, ctypes.c_void_p,
                                          ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
                                          ctypes.c_char_p, ctypes.c_size_t]
        for fn in (lib.combo_jpeg_info, lib.combo_jpeg_decode, lib.combo_jpeg_encode):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_jpeg(data: bytes, gray: bool = False, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB, or [H, W] with gray=True."""
    lib = _codec()
    err = ctypes.create_string_buffer(_ERRLEN)
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.combo_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(nc),
                           err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value) if gray else (h.value, w.value, 3), np.uint8)
    if lib.combo_jpeg_decode(data, len(data), int(gray), out.ctypes.data, out.nbytes, err,
                             _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str, gray: bool = False) -> np.ndarray:
    """The JPEG at `path` -> uint8 [H, W, 3] RGB, or [H, W] with gray=True."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, gray=gray, name=path)


def encode_jpeg(img: np.ndarray, quality: int = 95, subsampling: str = "420") -> bytes:
    """uint8 [H, W] gray or [H, W, 3] RGB -> baseline JPEG bytes; colour at
    4:2:0 ("420") or 4:4:4 ("444")."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: needs uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"encode_jpeg: subsampling must be one of {sorted(SUBSAMPLING)}, got "
                         f"{subsampling!r}")
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else 3
    # a block's worst case is about 216 bytes before stuffing: 8 bytes a
    # sample of the MCU-padded planes bounds every image
    cap = 4096 + 8 * C * (-(-H // 16) * 16) * (-(-W // 16) * 16)
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    if _codec().combo_jpeg_encode(img.ctypes.data, H, W, C, int(quality),
                                  SUBSAMPLING[subsampling], out.ctypes.data, cap,
                                  ctypes.byref(n), err, _ERRLEN):
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    return out[:n.value].tobytes()


def write_jpeg(path: str, img: np.ndarray, quality: int = 95, subsampling: str = "420") -> None:
    """Write uint8 [H, W] gray or [H, W, 3] RGB as a baseline JPEG file."""
    data = encode_jpeg(img, quality=quality, subsampling=subsampling)
    with open(path, "wb") as f:
        f.write(data)
