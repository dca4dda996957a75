"""Shared serialization primitives for durable state (counterpart of
``repro/recovery/serial.py``).

Arrays round-trip through a tiny self-describing record — ``{"dtype",
"shape", "data"|"b64"}`` — with raw bytes for binary containers
(msgpack) and base64 text for line-oriented JSON, and every durable
write goes through :func:`atomic_write_bytes` (temp file +
``os.replace``). The records are the reference's, bit for bit: a
``"bfloat16"`` record holds the raw 16-bit words, read here as
``uint16`` and viewed as ``torch.bfloat16`` (no ``ml_dtypes`` needed).
:func:`read_array_record` decodes a record from a file as it is read
(``msgpack_lite.StreamReader``), its bytes straight into the tensor.
"""
from __future__ import annotations

import base64
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

# torch dtype -> the numpy name a record carries
_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
          torch.bool: "bool"}
_FROM_NAME = {v: k for k, v in _NAMES.items()}


def array_record(arr, *, binary: bool = True) -> dict:
    """Encode a tensor (or anything ``np.asarray`` takes) as a
    self-describing dict. ``binary=True`` keeps raw bytes (msgpack);
    ``binary=False`` base64-encodes for JSON/JSONL lines."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = _NAMES[t.dtype]
        shape = list(t.shape)
        # bf16 has no numpy type: its 16-bit words go out as they are
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    else:
        a = np.asarray(arr)
        name, shape = str(a.dtype), list(a.shape)
    raw = np.ascontiguousarray(a).tobytes()
    rec = {"dtype": name, "shape": shape}
    if binary:
        rec["data"] = raw
    else:
        rec["b64"] = base64.b64encode(raw).decode("ascii")
    return rec


def record_array(rec: Optional[dict]) -> Optional[torch.Tensor]:
    """Decode an :func:`array_record` (either encoding) into a CPU tensor.
    None passes through so optional fields round-trip."""
    if rec is None:
        return None
    raw = rec["data"] if "data" in rec else base64.b64decode(rec["b64"])
    name = rec["dtype"]
    if name == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.uint16).copy()).view(torch.bfloat16)
    elif name in _FROM_NAME:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(name)).copy())
    else:
        raise ValueError(f"array record dtype {name!r} has no torch type")
    return t.reshape(rec["shape"])


def _bytes_of(t: torch.Tensor):
    """A writable byte view of a contiguous tensor's storage."""
    return t.reshape(-1).view(torch.uint8).numpy()


def read_array_record(r, like_shape=None,
                      each: Optional[Callable[[int, torch.Tensor], None]] = None
                      ) -> Optional[torch.Tensor]:
    """Decode the next :func:`array_record` (binary) of a
    ``msgpack_lite.StreamReader`` into a CPU tensor allocated once, its
    bytes read from the file straight into it; the record's dtype and
    shape must come ahead of its data, as both packages write them.
    ``like_shape``: the shape the record must have (``ValueError``
    otherwise). ``each``: read the array one index of its leading dim at
    a time instead, calling ``each(j, t)`` with index ``j``'s tensor (a
    new one each time), and return None: no more than one such slice is
    in memory at once."""
    name = shape = out = None
    read = False
    for _ in range(r.head("map")):
        key = r.read()
        if key == "dtype":
            name = r.read()
        elif key == "shape":
            shape = tuple(r.read())
        elif key == "data":
            if name is None or shape is None:
                raise ValueError("array record: its data comes ahead of its dtype and shape")
            if name not in _FROM_NAME:
                raise ValueError(f"array record dtype {name!r} has no torch type")
            if like_shape is not None and shape != tuple(like_shape):
                raise ValueError(f"leaf shape {shape} vs {tuple(like_shape)}")
            dt = _FROM_NAME[name]
            nbytes = r.head("bin")
            want = int(np.prod(shape)) * dt.itemsize
            if nbytes != want:
                raise ValueError(f"array record of {name} {shape}: {nbytes} bytes, want {want}")
            if each is None:
                out = torch.empty(shape, dtype=dt)
                r.read_into(_bytes_of(out))
            else:
                for j in range(shape[0]):
                    t = torch.empty(shape[1:], dtype=dt)
                    r.read_into(_bytes_of(t))
                    each(j, t)
            read = True
        else:
            raise ValueError(f"array record: field {key!r} is not dtype, shape or data")
    if not read:
        raise ValueError("array record without data")
    return out


def atomic_write_bytes(path, data: bytes) -> None:
    """Durably replace ``path`` with ``data``: write a sibling temp
    file, fsync it, then ``os.replace`` — readers only ever observe the
    old complete file or the new complete file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
