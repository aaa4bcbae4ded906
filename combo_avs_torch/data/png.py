"""PNG decoding and encoding in numpy and zlib, in place of cv2 and the JAX
package's native decoder (`combo_avs_tpu/native/combo_io.cpp`).

`read_png(path, gray=False)` takes 8-bit, non-interlaced PNGs of colour types
0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA), with any of
the five row filters, and returns uint8 [H, W, 3] RGB, or [H, W] with
gray=True, as `cv2.imread` (converted to RGB) and the native decoder return
them: alpha and transparency are dropped, gray is repeated into three
channels, and a colour image read as gray takes cv2's fixed-point BT.601,
y = (4899 r + 9617 g + 1868 b + 8192) >> 14. Anything else raises
`ValueError`; `data/image.py::read_image` reads a PNG or a JPEG by its
content.

`write_png(path, img)` writes uint8 [H, W] gray or [H, W, 3] RGB.

Rows filtered with Average or Paeth depend on the pixel to their left, so
such an image is unfiltered one anti-diagonal at a time (every pixel of a
diagonal depends only on earlier diagonals): H + W - 1 vector steps instead
of H * W scalar ones.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: truncated or corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int, path: str) -> np.ndarray:
    """Filtered scanlines [H, 1 + W * bpp] -> pixels [H, W, bpp] uint8."""
    ft = raw[:, 0].astype(np.int64)
    if ft.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG filter type {int(ft.max())}")
    x = raw[:, 1:].reshape(H, W, bpp)
    if ft.max(initial=0) <= 2:  # None, Sub, Up: whole rows at a time
        out = np.empty((H, W, bpp), np.uint8)
        prev = np.zeros((W, bpp), np.uint8)
        for r in range(H):
            if ft[r] == 0:
                row = x[r]
            elif ft[r] == 1:
                row = np.cumsum(x[r], axis=0, dtype=np.uint8)  # wraps mod 256
            else:
                row = x[r] + prev
            out[r] = prev = row
        return out

    # R holds the decoded pixels with a zero row above and a zero column to
    # the left; position (r, c) is R[r + 1, c + 1], flattened to one axis
    Wp = W + 1
    R = np.zeros(((H + 1) * Wp, bpp), np.int32)
    xf = x.reshape(H * W, bpp).astype(np.int32)
    rows_all = np.arange(H)
    for k in range(H + W - 1):
        r = rows_all[max(0, k - W + 1):min(H, k + 1)]
        c = k - r
        pos = (r + 1) * Wp + c + 1
        a, b, d = R[pos - 1], R[pos - Wp], R[pos - Wp - 1]  # left, up, up-left
        pa, pb, pc = np.abs(b - d), np.abs(a - d), np.abs(a + b - 2 * d)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        R[pos] = (xf[r * W + c] + pred[ft[r], np.arange(len(r))]) & 255
    return R.reshape(H + 1, Wp, bpp)[1:, 1:].astype(np.uint8)


def _gray(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.int32)
    y = (rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868 + 8192) >> 14
    return y.astype(np.uint8)


def read_png(path: str, gray: bool = False) -> np.ndarray:
    """The PNG at `path` -> uint8 [H, W, 3] RGB, or [H, W] with gray=True."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, gray=gray, name=path)


def decode_png(data: bytes, gray: bool = False, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB, or [H, W] with gray=True."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file (only PNG is decoded)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    W, H, depth, ctype, compression, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or compression or filt or interlace:
        raise ValueError(f"{name}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}); only 8-bit non-interlaced types 0, 2, 3, "
                         "4 and 6 are decoded")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{name}: PNG image data has {raw.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    px = _unfilter(raw.reshape(H, 1 + W * bpp), H, W, bpp, name)
    if ctype == 3:
        if palette is None or int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette PNG without a PLTE entry for every index")
        px = palette[px[..., 0]]
    elif ctype in (4, 6):
        px = px[..., :-1]  # alpha dropped
    if px.shape[-1] == 1:
        return px[..., 0] if gray else np.repeat(px, 3, axis=-1)
    return _gray(px) if gray else np.ascontiguousarray(px)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W] gray or [H, W, 3] RGB as a PNG, every row
    filtered with Up (the difference from the row above)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: needs uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, -1)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, rows.shape[1]), np.uint8))  # wraps mod 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    data = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data) + _chunk(b"IEND", b""))
