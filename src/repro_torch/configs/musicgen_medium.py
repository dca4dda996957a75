"""musicgen-medium [audio]: decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048. The EnCodec /
conditioning frontend is a stub: ``input_specs`` provides a precomputed
conditioning ``prefix_embed`` (B, 64, d_model).
"""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig
from .registry import register


@register("musicgen-medium")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=24, n_kv_heads=24, head_dim=64)
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        d_model=1536,
        vocab=2048,
        block_defs={"dense": BlockSpec(kind="attn_dense", attn=attn, d_ff=6144)},
        layout=(LayoutGroup(("dense",), 48),),
        prefix_len=64,
        source="arXiv:2306.05284",
    )
