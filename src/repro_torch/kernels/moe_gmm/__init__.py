from . import ops, ref
from .ops import GmmFn, gmm, gmm_hopper
from .ref import gmm_ref

__all__ = ["ops", "ref", "GmmFn", "gmm", "gmm_hopper", "gmm_ref"]
