"""Hand-written Hopper kernels for the port, each beside its plain
PyTorch version and a launch counter:

  moe_gmm    — grouped per-expert FFN matmul, ragged group sizes
               (replaces repro/kernels/moe_gmm, Pallas TPU); bf16 on
               tensor cores (routes "stream" for decode, "tc" for
               prefill), fp32 on CUDA cores ("fma")
  flash_attn — causal GQA flash attention forward, streamed K/V
               (replaces repro/kernels/flash_attn, Pallas TPU); bf16 on
               tensor cores ("tc"), fp32 on CUDA cores ("fma")
  int4_matmul — fused INT4-dequant matmul, HQQ group affine
               (replaces repro/kernels/int4_matmul, Pallas TPU); bf16
               split-K weight stream for decode ("stream"), tensor cores
               for prefill ("tc"), fp32 on CUDA cores ("fma")
  ssd_scan   — Mamba2 SSD chunked scan (replaces repro/kernels/ssd_scan,
               Pallas TPU); bf16 chunk-parallel on tensor cores ("tc"),
               fp32 one block per (b, h) walking the chunks ("fma")

``dispatch`` owns backend selection (ref | hopper | auto) and the launch
counters (per op, and per route); ``_build`` compiles ``*/csrc/*.cu``
with nvcc at first use; ``common/tc.cuh`` holds the PTX helpers the
tensor-core kernels share.
"""
from . import dispatch, flash_attn, int4_matmul, moe_gmm, ssd_scan

__all__ = ["dispatch", "flash_attn", "int4_matmul", "moe_gmm", "ssd_scan"]
