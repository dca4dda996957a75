from .model import (apply_model, compute_logits, decode_step, embed_tokens, init_cache,
                    init_params, prefill)
from .runtime import Runtime, resolve_device

__all__ = ["apply_model", "compute_logits", "decode_step", "embed_tokens", "init_cache",
           "init_params", "prefill", "Runtime", "resolve_device"]
