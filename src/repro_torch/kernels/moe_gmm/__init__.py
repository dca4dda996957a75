from . import ops, ref
from .ops import gmm, gmm_hopper
from .ref import gmm_ref

__all__ = ["ops", "ref", "gmm", "gmm_hopper", "gmm_ref"]
