from .engine import Completion, Request, ServingEngine, routing_trace, truncate_at_stop
from .sampling import greedy, row_generator, sample, sample_per_row

__all__ = ["Completion", "Request", "ServingEngine", "routing_trace", "truncate_at_stop",
           "greedy", "row_generator", "sample", "sample_per_row"]
