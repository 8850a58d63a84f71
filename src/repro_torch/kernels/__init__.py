"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` holds the public entry points; ``csrc/`` the CUDA sources, built by
``_build`` with ``nvcc`` for ``sm_90a`` at first use.  Nothing here imports
a compiler or touches a GPU at import time.
"""
