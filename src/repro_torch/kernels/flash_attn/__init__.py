from . import ops, ref
from .ops import flash, flash_hopper
from .ref import attention_ref

__all__ = ["ops", "ref", "flash", "flash_hopper", "attention_ref"]
