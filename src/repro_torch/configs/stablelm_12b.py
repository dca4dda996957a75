"""stablelm-12b [dense] [hf:stabilityai/stablelm-2-1_6b family].
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352."""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig
from .registry import register


@register("stablelm-12b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=32, n_kv_heads=8, head_dim=160)
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        d_model=5120,
        vocab=100_352,
        block_defs={"dense": BlockSpec(kind="attn_dense", attn=attn, d_ff=13_824)},
        layout=(LayoutGroup(("dense",), 40),),
        source="hf:stabilityai/stablelm-2-1_6b",
    )
