"""Causal flash attention (K3): the CUDA kernel's wrapper and its plain
version, in ``flash_attention.py``."""
