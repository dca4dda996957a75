"""Hand-written Hopper kernels for the port, each beside its plain
PyTorch version and a launch counter:

  moe_gmm    — grouped per-expert FFN matmul, ragged group sizes
               (replaces repro/kernels/moe_gmm, Pallas TPU)
  flash_attn — causal GQA flash attention forward, streamed K/V
               (replaces repro/kernels/flash_attn, Pallas TPU)

``dispatch`` owns backend selection (ref | hopper | auto) and the launch
counters; ``_build`` compiles ``*/csrc/*.cu`` with nvcc at first use.
``int4_matmul`` and ``ssd_scan`` are not ported yet (ROADMAP.md).
"""
from . import dispatch, flash_attn, moe_gmm

__all__ = ["dispatch", "flash_attn", "moe_gmm"]
