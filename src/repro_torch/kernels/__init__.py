"""Hand-written Hopper kernels (CUDA C++ sources under ``csrc/``), each
with its plain PyTorch version, its ``ref.py`` oracle, its ``ops.py``
wrapper + static burst list, and its co-verification sweep pieces."""
