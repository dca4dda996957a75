"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066]. 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6. First layer is a dense MLP (d_ff=10944),
remaining 27 are MoE — matching the release.

MELINOE applies directly; the 2 shared experts are always GPU/HBM
resident (never offloaded, excluded from the cache budget C).
"""
from .base import AttnSpec, BlockSpec, LayoutGroup, MelinoeSpec, ModelConfig, MoESpec
from .registry import register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128)
    moe = MoESpec(num_experts=64, top_k=6, d_ff=1408, num_shared=2, shared_d_ff=2 * 1408)
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        d_model=2048,
        vocab=102_400,
        block_defs={
            "dense0": BlockSpec(kind="attn_dense", attn=attn, d_ff=10_944),
            "moe": BlockSpec(kind="attn_moe", attn=attn, moe=moe),
        },
        layout=(LayoutGroup(("dense0",), 1), LayoutGroup(("moe",), 27)),
        melinoe=MelinoeSpec(),
        source="arXiv:2401.06066",
    )
