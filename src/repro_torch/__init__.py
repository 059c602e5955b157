"""PyTorch/CUDA port of the compute-continuum scheduler (``repro``).

Same layout and names as the reference package: ``core`` (the system and
workload model, the oracle, the metaheuristics), ``engine`` (packing and the
fitness engines) and ``kernels`` (the hand-written Hopper kernels beside
their plain PyTorch versions).  Entry points take ``device=`` and default to
``"cuda"``; only an explicit ``device="cpu"`` runs on the CPU.
"""
