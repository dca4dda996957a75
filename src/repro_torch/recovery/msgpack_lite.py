"""The msgpack subset the checkpoints use, encoded byte for byte as
``msgpack.packb(obj, use_bin_type=True)`` and decoded as
``msgpack.unpackb(data, raw=False)`` would: maps, arrays (lists and
tuples; decoded as lists), str, bin, ints, floats (written as float64),
nil and bools. The machine that runs the port on the card has no
``msgpack`` package, so the port carries its own.

:class:`StreamReader` decodes the same subset from a binary file object,
one object or one header at a time, and reads a ``bin`` field's bytes
straight into a buffer the caller gives (``read_into``): a checkpoint's
arrays are read without the whole file, or any of its fields, in memory.
"""
from __future__ import annotations

import io
import struct

__all__ = ["packb", "unpackb", "StreamReader"]


def _len_header(n: int, fix_tag: int, fix_max: int, tags) -> bytes:
    if n <= fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, limit in tags:
        if n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} is too large for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack_int(v: int, out: list) -> None:
    if v < 0:
        if v >= -32:
            out.append(struct.pack(">b", v))
        elif v >= -(1 << 7):
            out.append(b"\xd0" + struct.pack(">b", v))
        elif v >= -(1 << 15):
            out.append(b"\xd1" + struct.pack(">h", v))
        elif v >= -(1 << 31):
            out.append(b"\xd2" + struct.pack(">i", v))
        elif v >= -(1 << 63):
            out.append(b"\xd3" + struct.pack(">q", v))
        else:
            raise OverflowError(f"int {v} is too small for msgpack")
    elif v < 128:
        out.append(bytes([v]))
    elif v < 1 << 8:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif v < 1 << 16:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif v < 1 << 32:
        out.append(b"\xce" + struct.pack(">I", v))
    elif v < 1 << 64:
        out.append(b"\xcf" + struct.pack(">Q", v))
    else:
        raise OverflowError(f"int {v} is too large for msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 31, _STR))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_len_header(len(raw), 0, -1, _BIN))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 15, _ARR))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack an object of type {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# tag -> (struct format of the value, kind)
_FIXED = {0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
          0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
          0xD2: (">i", "int"), 0xD3: (">q", "int"), 0xCA: (">f", "float"),
          0xCB: (">d", "float")}
# tag -> (struct format of the length, kind)
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xDC: (">H", "arr"), 0xDD: (">I", "arr"), 0xDE: (">H", "map"),
          0xDF: (">I", "map")}


def _head(r):
    """The next object's tag: (kind, length) for a map, array, str or bin
    ("map", "arr", "str", "bin"), ("val", value) for anything else."""
    tag = r.take(1)[0]
    if tag <= 0x7F:
        return "val", tag
    if tag >= 0xE0:
        return "val", tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return "map", tag & 0x0F
    if 0x90 <= tag <= 0x9F:
        return "arr", tag & 0x0F
    if 0xA0 <= tag <= 0xBF:
        return "str", tag & 0x1F
    if tag == 0xC0:
        return "val", None
    if tag == 0xC2:
        return "val", False
    if tag == 0xC3:
        return "val", True
    if tag in _FIXED:
        return "val", r.unpack(_FIXED[tag][0])
    if tag in _SIZED:
        fmt, kind = _SIZED[tag]
        return kind, r.unpack(fmt)
    raise ValueError(f"msgpack tag 0x{tag:02x} is outside the supported subset")


def _read(r):
    kind, n = _head(r)
    if kind == "val":
        return n
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "arr":
        return [_read(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset above."""
    f = io.BytesIO(data)
    obj = StreamReader(f).read()
    if f.tell() != len(data):
        raise ValueError(f"{len(data) - f.tell()} bytes of extra data after the object")
    return obj


class StreamReader:
    """The subset above read from a binary file object ``f``, front to
    back: :meth:`read` decodes the next whole object, :meth:`head` only
    its header (a map's or array's item count, a str's or bin's byte
    count), after which the caller reads the items or, for a bin,
    :meth:`read_into` its bytes. A file that ends early raises
    ``ValueError``, as :func:`unpackb` does on truncated data."""

    def __init__(self, f):
        self.f = f

    def take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError("truncated msgpack data")
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        """The next object, decoded whole."""
        return _read(self)

    def head(self, kind: str) -> int:
        """The next object's header, which must be of ``kind`` ("map",
        "arr", "str" or "bin"): its length."""
        got, n = _head(self)
        if got != kind:
            raise ValueError(f"msgpack: expected a {kind}, found a {got}")
        return n

    def read_into(self, buf) -> None:
        """Fill ``buf`` (a writable buffer of a bin's bytes, or of the next
        part of them) from the file."""
        view = memoryview(buf).cast("B")
        while len(view):
            n = self.f.readinto(view)
            if not n:
                raise ValueError("truncated msgpack data")
            view = view[n:]

    def at_end(self) -> bool:
        return not self.f.read(1)
