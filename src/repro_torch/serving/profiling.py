"""Deprecated alias for :mod:`repro_torch.serving.scorers` (as
``repro/serving/profiling.py`` is for the reference's): re-exports the
scorers and warns once on import."""
from __future__ import annotations

import warnings

from .scorers import (  # noqa: F401
    predictor_expert_scores,
    prefill_expert_scores,
    prompt_router_profile,
)

warnings.warn(
    "repro_torch.serving.profiling is deprecated; import from "
    "repro_torch.serving.scorers instead",
    DeprecationWarning,
    stacklevel=2,
)

__all__ = [
    "predictor_expert_scores",
    "prefill_expert_scores",
    "prompt_router_profile",
]
