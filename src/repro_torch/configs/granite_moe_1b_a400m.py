"""granite-moe-1b-a400m [moe]: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.

MELINOE applies directly (has a router): C = E/4 = 8 by default.
"""
from .base import AttnSpec, BlockSpec, LayoutGroup, MelinoeSpec, ModelConfig, MoESpec
from .registry import register


@register("granite-moe-1b-a400m")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=16, n_kv_heads=8, head_dim=64)
    moe = MoESpec(num_experts=32, top_k=8, d_ff=512)
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        d_model=1024,
        vocab=49_155,
        block_defs={"moe": BlockSpec(kind="attn_moe", attn=attn, moe=moe)},
        layout=(LayoutGroup(("moe",), 24),),
        melinoe=MelinoeSpec(),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
