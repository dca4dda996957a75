"""PyTorch / CUDA port of the MELINOE reproduction (``src/repro`` is the
JAX reference it is held against).

Layout mirrors ``repro``: ``configs`` (copied), ``kernels`` (hand-written
Hopper kernels + their plain PyTorch versions), ``models``, ``core``
(expert cache + slab offload engine), ``serving``, ``training``, the
operations stack (``obs``, ``faults``, ``recovery``), the supervised
serving fleet (``fleet``), ``bridge`` (JAX
parameter trees <-> torch dicts) and ``launch``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
