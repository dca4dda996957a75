"""internvl2-76b [vlm]: InternViT + LLM backbone [arXiv:2404.16821].
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

The vision encoder + projector are stubs: ``input_specs`` provides a
precomputed ``prefix_embed`` (B, 256, d_model) of projected patch
embeddings; this config is the language decoder that consumes them.
"""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig
from .registry import register


@register("internvl2-76b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=64, n_kv_heads=8, head_dim=128)
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        d_model=8192,
        vocab=128_256,
        block_defs={"dense": BlockSpec(kind="attn_dense", attn=attn, d_ff=28_672)},
        layout=(LayoutGroup(("dense",), 80),),
        prefix_len=256,
        source="arXiv:2404.16821",
    )
