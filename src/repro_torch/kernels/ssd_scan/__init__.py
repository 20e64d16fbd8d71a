"""The Mamba2 SSD intra-chunk product (K4): the CUDA kernel's wrapper and
its plain version, in ``ssd_scan.py``."""
