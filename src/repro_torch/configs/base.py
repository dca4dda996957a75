"""Configuration dataclasses for the repro framework.

A model is described as a *layout* of block groups. Each group is a
repeated pattern of named blocks; the pattern is scanned with
``lax.scan`` over the repeat dimension so heterogeneous stacks (gemma2
local/global alternation, zamba2 mamba+shared-attention interleave,
deepseek dense-first-layer) still compile to compact HLO.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnSpec:
    """Grouped-query attention spec."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    window: Optional[int] = None  # None => global causal attention

    def __post_init__(self):
        assert self.n_heads % self.n_kv_heads == 0, (
            f"n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}"
        )

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoESpec:
    """Sparsely-gated expert FFN spec (Eq. 1-2 of the paper)."""

    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    num_shared: int = 0  # always-resident shared experts (DeepSeekMoE)
    shared_d_ff: int = 0  # fused hidden dim of the shared expert block
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None

    def __post_init__(self):
        assert 0 < self.top_k <= self.num_experts

    def capacity(self, n_tokens: int) -> int:
        """GShard-style per-expert capacity."""
        cap = int(math.ceil(n_tokens * self.top_k / self.num_experts * self.capacity_factor))
        return max(cap, self.top_k)


@dataclass(frozen=True)
class SSMSpec:
    """Mamba2 / SSD spec (state-space duality, arXiv:2405.21060)."""

    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        di = self.d_inner(d_model)
        assert di % self.head_dim == 0
        return di // self.head_dim


@dataclass(frozen=True)
class BlockSpec:
    """One transformer-ish block: pre-norm + mixer + pre-norm + channel-mixer."""

    kind: str  # "attn_dense" | "attn_moe" | "mamba" | "shared_attn"
    attn: Optional[AttnSpec] = None
    d_ff: int = 0  # dense (gated) MLP hidden dim; 0 => no MLP (pure mamba block)
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None

    def __post_init__(self):
        if self.kind in ("attn_dense", "shared_attn"):
            assert self.attn is not None
        if self.kind == "attn_moe":
            assert self.attn is not None and self.moe is not None
        if self.kind == "mamba":
            assert self.ssm is not None


@dataclass(frozen=True)
class LayoutGroup:
    """``pattern`` applied ``repeats`` times, scanned over repeats."""

    pattern: Tuple[str, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class MelinoeSpec:
    """Hyper-parameters of the paper's technique (Sec 3.1, App B.2)."""

    enabled: bool = True
    cache_capacity: int = 0  # C; 0 => default E // 4
    gamma: float = 0.9
    rho: float = 0.1
    lambda_cs: float = 0.5
    lambda_rm: float = 0.1
    request_mode: str = "soft"  # "soft" | "hard_st"
    base_router_mode: str = "same_trajectory"  # | "exact"
    lora_rank: int = 32
    lora_alpha: float = 16.0
    rm_token_chunk: int = 128  # token chunking for the O(E^2) rank loss
    uniform_cache_init: bool = True  # skip the cache-fill phase (Sec 3.1.1)
    cs_impl: str = "scan"  # paper-faithful sequential | "assoc" (log-depth, §Perf)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    vocab: int
    block_defs: Mapping[str, BlockSpec]
    layout: Tuple[LayoutGroup, ...]
    norm_eps: float = 1e-6
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    prefix_len: int = 0  # frontend stub embeddings prepended (vlm/audio)
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"
    long_context_window: int = 8192  # sliding window used for long_500k variants
    melinoe: Optional[MelinoeSpec] = None
    source: str = ""  # citation for the config

    # ---- derived -----------------------------------------------------
    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.layout)

    def blocks_in_order(self) -> Tuple[str, ...]:
        out = []
        for g in self.layout:
            out.extend(list(g.pattern) * g.repeats)
        return tuple(out)

    @property
    def moe_spec(self) -> Optional[MoESpec]:
        for b in self.block_defs.values():
            if b.moe is not None:
                return b.moe
        return None

    @property
    def n_moe_layers(self) -> int:
        return sum(1 for k in self.blocks_in_order() if self.block_defs[k].moe is not None)

    @property
    def has_router(self) -> bool:
        return self.n_moe_layers > 0

    def melinoe_cache_capacity(self) -> int:
        spec = self.moe_spec
        assert spec is not None
        if self.melinoe and self.melinoe.cache_capacity:
            return self.melinoe.cache_capacity
        return max(spec.top_k, spec.num_experts // 4)

    def validate(self) -> None:
        for g in self.layout:
            for name in g.pattern:
                assert name in self.block_defs, f"unknown block {name!r}"
        assert self.n_layers > 0

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------
    def param_counts(self) -> dict:
        """Returns dict with total / active parameter counts (analytic)."""
        d = self.d_model
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d  # lm head
        active = total
        for name in self.blocks_in_order():
            b = self.block_defs[name]
            t = a = 0
            if b.attn is not None:
                s = b.attn
                attn_p = d * s.q_dim + 2 * d * s.kv_dim + s.q_dim * d
                if s.qk_norm:
                    attn_p += 2 * s.head_dim
                t += attn_p
                a += attn_p
            if b.d_ff:
                mlp_p = 3 * d * b.d_ff
                t += mlp_p
                a += mlp_p
            if b.moe is not None:
                m = b.moe
                t += m.num_experts * 3 * d * m.d_ff + m.num_experts * d  # experts + router
                a += m.top_k * 3 * d * m.d_ff + m.num_experts * d
                if m.shared_d_ff:
                    t += 3 * d * m.shared_d_ff
                    a += 3 * d * m.shared_d_ff
            if b.ssm is not None:
                s = b.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                conv_dim = di + 2 * s.n_groups * s.d_state
                ssm_p = (
                    d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj (z,x,B,C,dt)
                    + conv_dim * s.d_conv  # conv1d
                    + 2 * nh  # A_log, D
                    + di  # gated norm
                    + di * d  # out_proj
                )
                t += ssm_p
                a += ssm_p
            # two / three pre-norms per block
            t += 2 * d
            a += 2 * d
            total += t
            active += a
        return {"total": total, "active": active}


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Mapping[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Smoke-test reduction
# ---------------------------------------------------------------------------


def make_smoke(cfg: ModelConfig, *, d_model: int = 128, vocab: int = 512) -> ModelConfig:
    """Reduced variant of the same family: <=2 pattern blocks, 1 repeat,
    d_model<=512, <=4 experts. Used by per-arch CPU smoke tests."""

    def shrink_attn(a: Optional[AttnSpec]) -> Optional[AttnSpec]:
        if a is None:
            return None
        return replace(
            a, n_heads=4, n_kv_heads=2 if a.n_kv_heads < a.n_heads else 4, head_dim=32
        )

    def shrink_block(b: BlockSpec) -> BlockSpec:
        moe = None
        if b.moe is not None:
            moe = replace(
                b.moe,
                num_experts=4,
                top_k=min(b.moe.top_k, 2),
                d_ff=64,
                shared_d_ff=64 if b.moe.shared_d_ff else 0,
                capacity_factor=2.0,
            )
        ssm = None
        if b.ssm is not None:
            ssm = replace(b.ssm, d_state=16, head_dim=32, chunk=32)
        return BlockSpec(
            kind=b.kind,
            attn=shrink_attn(b.attn),
            d_ff=256 if b.d_ff else 0,
            moe=moe,
            ssm=ssm,
        )

    block_defs = {k: shrink_block(v) for k, v in cfg.block_defs.items()}
    # keep one block of each distinct kind across the WHOLE layout (so e.g.
    # deepseek keeps its MoE block even though layer 0 is dense), up to 3;
    # duplicate a single-kind pattern to 2 layers.
    seen, kept = set(), []
    for p in cfg.blocks_in_order():
        if p not in seen:
            kept.append(p)
            seen.add(p)
        if len(kept) == 3:
            break
    pattern = tuple(kept) if len(kept) > 1 else (kept[0], kept[0])
    layout = (LayoutGroup(pattern, 1),)
    mel = cfg.melinoe
    if mel is not None:
        mel = replace(mel, cache_capacity=0, lora_rank=4, rm_token_chunk=32)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        vocab=vocab,
        block_defs=block_defs,
        layout=layout,
        prefix_len=min(cfg.prefix_len, 8),
        max_seq_len=1024,
        melinoe=mel,
        tie_embeddings=cfg.tie_embeddings,
    )
