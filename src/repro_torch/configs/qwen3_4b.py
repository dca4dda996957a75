"""qwen3-4b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-8B family].
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936."""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig
from .registry import register


@register("qwen3-4b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True, rope_theta=1e6)
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        d_model=2560,
        vocab=151_936,
        block_defs={"dense": BlockSpec(kind="attn_dense", attn=attn, d_ff=9728)},
        layout=(LayoutGroup(("dense",), 36),),
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B",
    )
