"""PyTorch/CUDA port of the ParamSpMM system (the JAX package ``repro`` is
its reference).  Host-side formats and config selection live in
``core``, the hand-written CUDA kernels in ``csrc`` with their wrappers in
``kernels``, the GNN models in ``models`` and the serving tier in
``serve``."""
