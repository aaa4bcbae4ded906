"""Event storage and metric writers (detectron2's EventStorage surface).

Port of `combo_avs_tpu/utils/events.py`: scalars are recorded per
iteration, smoothed over a window for display, and flushed by a JSON writer
(d2's `metrics.json`, one {"iteration": i, ...} dict per line) and a
TensorBoard writer. The JAX package's TensorBoard writer goes through
`torch.utils.tensorboard`, which imports TensorFlow where it is installed
(and with it jax); this one writes the event file itself: TFRecord framing
(length, masked CRC-32C of the length, the record, masked CRC-32C of the
record) around `Event` protos holding one simple-value scalar each.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import time
from collections import defaultdict, deque
from typing import Dict


class EventStorage:
    def __init__(self, start_iter: int = 0, window_size: int = 20):
        self.iter = start_iter
        self._history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=max(window_size, 1)))
        self._latest: Dict[str, tuple] = {}  # name -> (value, iteration)

    def put_scalar(self, name: str, value) -> None:
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = (value, self.iter)

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> Dict[str, tuple]:
        """{name: (value, iteration)}."""
        return dict(self._latest)

    def median(self, name: str) -> float:
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else float("nan")

    def latest_with_smoothing_hint(self) -> Dict[str, tuple]:
        """{name: (median over the window, iteration)}, as d2's writers read
        it."""
        return {name: (self.median(name), it) for name, (_, it) in self._latest.items()}

    def step(self) -> None:
        self.iter += 1


class JSONWriter:
    """d2's metrics.json: one {"iteration": i, ...} dict per line, holding
    only the scalars recorded since the previous write."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._last_write: Dict[str, int] = {}

    def write(self, storage: EventStorage) -> None:
        fresh = {name: (value, it) for name, (value, it) in
                 storage.latest_with_smoothing_hint().items()
                 if it > self._last_write.get(name, -1)}
        if not fresh:
            return
        row = {"iteration": storage.iter}
        for name, (value, it) in fresh.items():
            row[name] = value
            self._last_write[name] = it
        with open(self._path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        pass


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()
_FILE_IDS = itertools.count()  # two writers of one process and second: two files


def _masked_crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(step: int = 0, file_version: str = "", tag: str = "", value: float = 0.0) -> bytes:
    """An Event proto: wall_time (1), step (2), and file_version (3) or a
    Summary (5) of one Value with tag (1) and simple_value (2)."""
    out = b"\x09" + struct.pack("<d", time.time())
    if step:
        out += b"\x10" + _varint(step)
    if file_version:
        out += _field(3, file_version.encode())
    if tag:
        out += _field(5, _field(1, _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)))
    return out


class TensorBoardWriter:
    """Scalars to an event file under `log_dir`, each (scalar, iteration)
    once."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"events.out.tfevents.{int(time.time())}."
                                          f"{socket.gethostname()}.{os.getpid()}.{next(_FILE_IDS)}")
        self._file = open(self.path, "ab")
        self._record(_event(file_version="brain.Event:2"))
        self._last_write: Dict[str, int] = {}

    def _record(self, data: bytes) -> None:
        head = struct.pack("<Q", len(data))
        self._file.write(head + struct.pack("<I", _masked_crc32c(head)) + data
                         + struct.pack("<I", _masked_crc32c(data)))

    def write(self, storage: EventStorage) -> None:
        for name, (value, it) in storage.latest().items():
            if it > self._last_write.get(name, -1):
                self._record(_event(step=it, tag=name, value=value))
                self._last_write[name] = it
        self._file.flush()

    def close(self) -> None:
        self._file.close()
