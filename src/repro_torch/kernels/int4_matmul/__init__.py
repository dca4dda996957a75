from . import ops, ref
from .ops import MatmulQWeight, int4_matmul, int4_matmul_hopper, quantize_matmul_weight
from .ref import dequant_ref, int4_matmul_ref

__all__ = ["ops", "ref", "MatmulQWeight", "int4_matmul", "int4_matmul_hopper",
           "quantize_matmul_weight", "dequant_ref", "int4_matmul_ref"]
