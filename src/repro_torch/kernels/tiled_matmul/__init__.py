"""The tiled matrix product (K5): the CUDA kernel's wrapper and its plain
version, in ``tiled_matmul.py``."""
