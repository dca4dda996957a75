"""OLMoE-1B-7B (paper backbone, Table 6): 16L, 64 experts/layer, top-8,
6.9B total / 1.3B active [openreview:xXTkbTBmqq]."""
from .base import AttnSpec, BlockSpec, LayoutGroup, MelinoeSpec, ModelConfig, MoESpec
from .registry import register


@register("olmoe")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128, qk_norm=True)
    moe = MoESpec(num_experts=64, top_k=8, d_ff=1024)
    return ModelConfig(
        name="olmoe",
        family="moe",
        d_model=2048,
        vocab=50_304,
        block_defs={"moe": BlockSpec(kind="attn_moe", attn=attn, moe=moe)},
        layout=(LayoutGroup(("moe",), 16),),
        melinoe=MelinoeSpec(cache_capacity=16),  # C=16 per the paper (E/4)
        source="paper Table 6 / OLMoE",
    )
