"""Durable-state primitives of the port: the array records and atomic
writes behind the model checkpoints (``recovery/serial.py``), and the
msgpack subset they are written in (``recovery/msgpack_lite.py``). The
server snapshots, request journal and watchdog of the reference's
``recovery/`` are not ported yet."""
from .serial import array_record, atomic_write_bytes, record_array

__all__ = ["array_record", "atomic_write_bytes", "record_array"]
