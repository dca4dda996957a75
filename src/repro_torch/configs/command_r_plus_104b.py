"""command-r-plus-104b [dense]: GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000."""
from .base import AttnSpec, BlockSpec, LayoutGroup, ModelConfig
from .registry import register


@register("command-r-plus-104b")
def config() -> ModelConfig:
    attn = AttnSpec(n_heads=96, n_kv_heads=8, head_dim=128)
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        d_model=12_288,
        vocab=256_000,
        block_defs={"dense": BlockSpec(kind="attn_dense", attn=attn, d_ff=33_792)},
        layout=(LayoutGroup(("dense",), 64),),
        source="hf:CohereForAI/c4ai-command-r-v01",
    )
