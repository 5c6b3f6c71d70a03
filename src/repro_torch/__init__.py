"""PyTorch/CUDA port of the parallel scale-free graph generators.

Runs the JAX package's algorithms with torch tensors and hand-written
Hopper kernels, bit-identical to it for the same spec. Entry point:
``repro_torch.api`` (``GraphSpec -> plan() -> generate()``).
"""
