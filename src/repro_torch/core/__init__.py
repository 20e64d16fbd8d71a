"""The Fulcrum system on PyTorch: device model, problems, GMD, the
trace-driven engine and the scheduler (counterpart of ``repro.core``)."""
