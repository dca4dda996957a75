from . import ops, ref
from .ops import ssd, ssd_hopper
from .ref import ssd_chunked, ssd_scan_ref

__all__ = ["ops", "ref", "ssd", "ssd_chunked", "ssd_hopper", "ssd_scan_ref"]
