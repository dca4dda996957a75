"""phi35-moe-smoke at Phi-3.5-MoE's expert ratios: ``make_smoke`` cuts
every MoE config to 4 experts, and Phi has 16, top-2, served at C = 4
(paper Table 7: E/4, which the smoke config's cache capacity of 0 resolves
to). With 16 experts E / C = 4 as at full width, and a step's overflow
group or INT4 spillover can take up to 12 experts a layer, where at 4
experts it takes at most 2. The same ``dataclasses.replace`` applies to
either package's config."""
import dataclasses

SMOKE = "phi35-moe-smoke"
# the port's registry name of the port's config, for the entry points that
# resolve a config by name (a name ending in "-smoke" would be cut again)
NAME = "phi35-moe-e16-tiny"


def sixteen_experts(cfg):
    """``cfg`` (either package's) with every MoE block at 16 experts, top-2."""
    blocks = {k: dataclasses.replace(b, moe=dataclasses.replace(b.moe, num_experts=16, top_k=2))
              if b.moe is not None else b for k, b in cfg.block_defs.items()}
    return dataclasses.replace(cfg, block_defs=blocks)


def register_port() -> str:
    """Register the port's config under NAME; returns NAME."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import register

    cfg = dataclasses.replace(sixteen_experts(get_config(SMOKE)), name=NAME)
    register(NAME)(lambda: cfg)
    return NAME
