"""Mixtral-8x7B (paper backbone, Table 6): 32L, 8 experts/layer, top-2,
46.7B total / 12.9B active [arXiv:2401.04088]."""
from .base import AttnSpec, BlockSpec, LayoutGroup, MelinoeSpec, ModelConfig, MoESpec
from .registry import register


@register("mixtral-8x7b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128)
    moe = MoESpec(num_experts=8, top_k=2, d_ff=14_336)
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        d_model=4096,
        vocab=32_000,
        block_defs={"moe": BlockSpec(kind="attn_moe", attn=attn, moe=moe)},
        layout=(LayoutGroup(("moe",), 32),),
        melinoe=MelinoeSpec(cache_capacity=2),  # paper Table 7: C=2 (E/4)
        source="paper Table 6 / Mixtral",
    )
