"""gemma2-27b [dense]: local+global alternating attention, logit softcap
[arXiv:2408.00118]. 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000."""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig
from .registry import register


@register("gemma2-27b")
def config() -> ModelConfig:
    local = AttnSpec(
        n_heads=32, n_kv_heads=16, head_dim=128, window=4096, attn_softcap=50.0
    )
    glob = AttnSpec(n_heads=32, n_kv_heads=16, head_dim=128, attn_softcap=50.0)
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        d_model=4608,
        vocab=256_000,
        block_defs={
            "local": BlockSpec(kind="attn_dense", attn=local, d_ff=36_864),
            "global": BlockSpec(kind="attn_dense", attn=glob, d_ff=36_864),
        },
        layout=(LayoutGroup(("local", "global"), 23),),
        logit_softcap=30.0,
        tie_embeddings=True,
        embed_scale=True,
        source="arXiv:2408.00118",
    )
