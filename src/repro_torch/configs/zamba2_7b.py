"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64.

Layout: 13 x (5 mamba + 1 shared-attention) + 3 mamba = 81 layers.
The shared-attention block's parameters are *shared* across all 13
occurrences (zamba's defining trait) — they live in the model's
``shared`` subtree, not in the scanned stack.
"""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig, SSMSpec
from .registry import register


@register("zamba2-7b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=32, n_kv_heads=32, head_dim=112)
    ssm = SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64)
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        d_model=3584,
        vocab=32_000,
        block_defs={
            "mamba": BlockSpec(kind="mamba", ssm=ssm),
            "shared_attn": BlockSpec(kind="shared_attn", attn=attn, d_ff=14_336),
        },
        layout=(
            LayoutGroup(("mamba",) * 5 + ("shared_attn",), 13),
            LayoutGroup(("mamba",), 3),
        ),
        source="arXiv:2411.15242",
    )
