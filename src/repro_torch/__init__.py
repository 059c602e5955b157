"""PyTorch/CUDA port of the compute-continuum scheduler (``repro``).

Same layout and names as the reference package: ``core`` (the system and
workload model, the oracle, the metaheuristics), ``engine`` (packing, the
fitness engines and the multi-device instance axis), ``kernels`` (the
hand-written Hopper kernels beside their plain PyTorch versions),
``service``, ``cycling``, ``campaigns``, ``topology`` (generated continua
and the digital twin) and ``obs``.  Entry points take ``device=`` and default to
``"cuda"``; only an explicit ``device="cpu"`` runs on the CPU.
"""
