"""olmoe-mini: the CPU-scale reproduction workhorse (~100M params).

Same family as OLMoE (fine-grained MoE, qk-norm attention) at a scale a
CPU can fine-tune for a few hundred steps. Used by the end-to-end
example script and the paper-claim benchmarks.
"""
from .base import AttnSpec, BlockSpec, LayoutGroup, MelinoeSpec, ModelConfig, MoESpec
from .registry import register


@register("olmoe-mini")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=8, n_kv_heads=8, head_dim=32, qk_norm=True)
    moe = MoESpec(num_experts=32, top_k=4, d_ff=512, capacity_factor=2.0)
    return ModelConfig(
        name="olmoe-mini",
        family="moe",
        d_model=256,
        vocab=4096,
        block_defs={"moe": BlockSpec(kind="attn_moe", attn=attn, moe=moe)},
        layout=(LayoutGroup(("moe",), 8),),
        max_seq_len=2048,
        melinoe=MelinoeSpec(cache_capacity=8, lora_rank=8),  # C = E/4
        source="reduced OLMoE for CPU reproduction",
    )
