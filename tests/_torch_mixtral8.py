"""mixtral-8x7b-smoke at Mixtral-8x7B's expert ratios, for the baseline
tests: ``make_smoke`` cuts every MoE config to 4 experts, and Mixtral has 8,
top-2, served at C = 2 (paper Table 7). With 8 experts E / C = 4 as at full
width, and quant_cache's 3C = 6 < E, so its INT4 spillover runs. The same
``dataclasses.replace`` applies to either package's config."""
import dataclasses

SMOKE = "mixtral-8x7b-smoke"
# the port's registry name of the port's config, for the entry points that
# resolve a config by name (a name ending in "-smoke" would be cut again)
NAME = "mixtral-8x7b-e8-tiny"


def eight_experts(cfg):
    """``cfg`` (either package's) with every MoE block at 8 experts, top-2."""
    blocks = {k: dataclasses.replace(b, moe=dataclasses.replace(b.moe, num_experts=8, top_k=2))
              if b.moe is not None else b for k, b in cfg.block_defs.items()}
    return dataclasses.replace(cfg, block_defs=blocks)


def register_port() -> str:
    """Register the port's config under NAME; returns NAME."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import register

    cfg = dataclasses.replace(eight_experts(get_config(SMOKE)), name=NAME)
    register(NAME)(lambda: cfg)
    return NAME
