"""Hand-written Hopper kernels K1-K4 with their plain PyTorch versions.

``dispatch`` holds the entry points, routing rules and launch counts;
``reference`` the plain versions; ``build`` compiles ``csrc`` with nvcc.
Nothing here builds or imports a GPU toolchain at import time.
"""
