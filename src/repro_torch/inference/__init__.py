from .engine import Completion, Request, ServingEngine, truncate_at_stop
from .sampling import greedy

__all__ = ["Completion", "Request", "ServingEngine", "truncate_at_stop", "greedy"]
