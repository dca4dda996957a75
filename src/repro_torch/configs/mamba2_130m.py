"""mamba2-130m [ssm]: SSD (state-space duality) [arXiv:2405.21060].
24L d_model=768 (attn-free) vocab=50280, ssm_state=128."""
from .base import BlockSpec, LayoutGroup, ModelConfig, SSMSpec
from .registry import register


@register("mamba2-130m")
def config() -> ModelConfig:
    ssm = SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64)
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        d_model=768,
        vocab=50_280,
        block_defs={"mamba": BlockSpec(kind="mamba", ssm=ssm)},
        layout=(LayoutGroup(("mamba",), 24),),
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )
