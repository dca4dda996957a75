from .model import compute_logits, embed_tokens, init_params
from .runtime import Runtime, resolve_device

__all__ = ["compute_logits", "embed_tokens", "init_params", "Runtime",
           "resolve_device"]
