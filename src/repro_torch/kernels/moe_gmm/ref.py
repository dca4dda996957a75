"""Plain PyTorch version of the grouped expert matmul (counterpart of
``repro/kernels/moe_gmm/ref.py::gmm_ref``)."""
import torch


def gmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, M, K), b (E, K, N) -> (E, M, N): fp32 products, output in
    ``a.dtype``. Ragged groups need no special case: rows past a group's
    size are zero by contract, so they come out zero."""
    return torch.einsum("emk,ekn->emn", a.float(), b.float()).to(a.dtype)
