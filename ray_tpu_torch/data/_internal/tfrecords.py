"""TFRecord framing + tf.train.Example codec, dependency-free.

Reference: ``python/ray/data/datasource/tfrecords_datasource.py`` reads
TFRecords through tensorflow; the hermetic TPU image doesn't bake TF,
and the two formats involved are tiny and frozen, so they are decoded
by hand:

- TFRecord framing (tensorflow/core/lib/io/record_writer.cc):
  ``u64 length | u32 masked-crc32c(length) | bytes | u32 masked-crc(data)``
- ``tf.train.Example`` protobuf: Example{1: Features{1: map<string,
  Feature>}} with Feature = one of bytes_list(1)/float_list(2)/
  int64_list(3), each a repeated field.

CRCs are verified on read (crc32c via the polynomial table below);
write produces files tensorflow can read back.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Union

# ----------------------------------------------------------- crc32c
_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ----------------------------------------------------------- framing
def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,), (lcrc,) = (struct.unpack("<Q", header[:8]),
                                  struct.unpack("<I", header[8:]))
            if _masked_crc(header[:8]) != lcrc:
                raise ValueError(f"corrupt length crc in {path}")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(data) != dcrc:
                raise ValueError(f"corrupt data crc in {path}")
            yield data


def write_records(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            hdr = struct.pack("<Q", len(rec))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


# ------------------------------------------------- minimal protobuf
def _read_varint(buf: bytes, i: int):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _fields(buf: bytes) -> Iterator[tuple]:
    """(field_number, wire_type, value) over a serialized message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:      # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:    # 64-bit
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:    # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:    # 32-bit
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    for field, _, val in _fields(buf):
        if field == 1:     # BytesList{1: repeated bytes}
            return [v for f, _, v in _fields(val) if f == 1]
        if field == 2:     # FloatList{1: repeated float, packed}
            floats: List[float] = []
            for f, wire, v in _fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    floats.extend(struct.unpack(f"<{len(v)//4}f", v))
                else:
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:     # Int64List{1: repeated int64, packed}
            ints: List[int] = []
            for f, wire, v in _fields(val):
                if f != 1:
                    continue
                if wire == 2:
                    i = 0
                    while i < len(v):
                        n, i = _read_varint(v, i)
                        ints.append(_to_signed(n))
                else:
                    ints.append(_to_signed(v))
            return ints
    return []


def _to_signed(n: int) -> int:
    return n - (1 << 64) if n >= (1 << 63) else n


def parse_example(record: bytes) -> Dict[str, Any]:
    """Example proto -> {name: scalar-or-list} (singletons unwrap)."""
    out: Dict[str, Any] = {}
    for field, _, features in _fields(record):
        if field != 1:   # Example.features
            continue
        for f2, _, entry in _fields(features):
            if f2 != 1:  # Features.feature map entries
                continue
            name, value = None, []
            for f3, _, v in _fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    value = _parse_feature(v)
            if name is not None:
                out[name] = value[0] if len(value) == 1 else value
    return out


# ----------------------------------------------------------- encoding
def _encode_field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((field << 3) | wire) + payload


def _encode_len(field: int, payload: bytes) -> bytes:
    return _encode_field(field, 2, _write_varint(len(payload)) + payload)


def encode_example(row: Dict[str, Union[bytes, str, int, float, list]]
                   ) -> bytes:
    """{name: value} -> serialized tf.train.Example."""
    entries = b""
    for name, value in row.items():
        vals = value if isinstance(value, list) else [value]
        if all(isinstance(v, (bytes, str)) for v in vals):
            items = b"".join(
                _encode_len(1, v.encode() if isinstance(v, str) else v)
                for v in vals)
            feature = _encode_len(1, items)           # BytesList
        elif all(isinstance(v, int) for v in vals):
            packed = b"".join(_write_varint(v & ((1 << 64) - 1))
                              for v in vals)
            feature = _encode_len(3, _encode_len(1, packed))  # Int64List
        else:
            packed = struct.pack(f"<{len(vals)}f",
                                 *[float(v) for v in vals])
            feature = _encode_len(2, _encode_len(1, packed))  # FloatList
        entry = _encode_len(1, name.encode()) + _encode_len(2, feature)
        entries += _encode_len(1, entry)
    return _encode_len(1, entries)   # Example.features
