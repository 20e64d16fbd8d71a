"""Model configurations the port registers (``repro.configs`` on
PyTorch)."""
