"""Phi-3.5-MoE (paper backbone, Table 6): 32L, 16 experts/layer, top-2,
42B total / 6.6B active [arXiv:2404.14219]."""
from .base import AttnSpec, BlockSpec, LayoutGroup, MelinoeSpec, ModelConfig, MoESpec
from .registry import register


@register("phi35-moe")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128)
    moe = MoESpec(num_experts=16, top_k=2, d_ff=6400)
    return ModelConfig(
        name="phi35-moe",
        family="moe",
        d_model=4096,
        vocab=32_064,
        block_defs={"moe": BlockSpec(kind="attn_moe", attn=attn, moe=moe)},
        layout=(LayoutGroup(("moe",), 32),),
        melinoe=MelinoeSpec(cache_capacity=4),  # paper Table 7: C=4 (E/4)
        source="paper Table 6 / Phi-3.5-MoE",
    )
