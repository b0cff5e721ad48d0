"""Minimal TensorBoard event-file writer (no tensorflow/tensorboardX).

Replaces the reference's `SummaryWriter(log_dir/'tensorboard')`
(reference train.py:281, scalar adds at train.py:463-466) with a
dependency-free implementation of the tfevents format: TFRecord framing
(length + masked crc32c) around hand-encoded Event/Summary protobufs with
`simple_value` scalars. TensorBoard reads these natively.

A copy of ``openpcseg_tpu/utils/tb_writer.py``, held to it by
tests/test_torch_data.py.
"""
from __future__ import annotations

import os
import struct
import time
from pathlib import Path

# ---- crc32c (Castagnoli), table-driven ----------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    _CRC_TABLE = tbl
    return tbl


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---- minimal protobuf encoding ------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(step: int, wall_time: float, *, file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    ev = _double(1, wall_time) + _int64(2, step)
    if file_version is not None:
        ev += _len_delim(3, file_version.encode())
    if scalars:
        summ = b"".join(
            _len_delim(1, _len_delim(1, tag.encode()) + _float(2, float(v)))
            for tag, v in scalars.items())
        ev += _len_delim(5, summ)
    return ev


class TBWriter:
    """Append-only scalar writer producing `events.out.tfevents.*` files."""

    def __init__(self, log_dir):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{os.uname().nodename}")
        self._f = open(self.dir / fname, "ab")
        self._write(_event(0, time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        hdr = struct.pack("<Q", len(record))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(int(step), time.time(), scalars={tag: value}))

    def add_scalars(self, scalars: dict, step: int) -> None:
        """One event holding several scalar summaries."""
        self._write(_event(int(step), time.time(), scalars=scalars))

    def close(self) -> None:
        self._f.close()
