"""The port's runtime layer (``repro.runtime`` on PyTorch): clocks, the
serving engine and the real-mode managed interleave executor."""
