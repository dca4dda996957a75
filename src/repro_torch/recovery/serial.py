"""Shared serialization primitives for durable state (counterpart of
``repro/recovery/serial.py``).

Arrays round-trip through a tiny self-describing record — ``{"dtype",
"shape", "data"|"b64"}`` — with raw bytes for binary containers
(msgpack) and base64 text for line-oriented JSON, and every durable
write goes through :func:`atomic_write_bytes` (temp file +
``os.replace``). The records are the reference's, bit for bit: a
``"bfloat16"`` record holds the raw 16-bit words, read here as
``uint16`` and viewed as ``torch.bfloat16`` (no ``ml_dtypes`` needed).
"""
from __future__ import annotations

import base64
import os
from pathlib import Path
from typing import Optional

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
