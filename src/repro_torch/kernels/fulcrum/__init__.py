"""The Fulcrum engine's two kernels, ported from the Pallas package
``repro.kernels.fulcrum`` to CUDA C++ for sm_90a:

 * ``maxplus_scan`` — the managed-interleaving recurrence
   ``c_k = max(c_{k-1}, ready_k) + e_k`` fused with the training
   slack-fill count (``csrc/maxplus_scan.cu``);
 * ``lane_sort`` — the per-lane padded sort behind the batched report
   builder, with per-lane budget-violation counts (``csrc/lane_sort.cu``).

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version for CPU tensors, and counts its launches in ``<wrapper>.launches``.
Import them from their modules (``...fulcrum.maxplus_scan``); the package
does not re-export them, so each module name stays the module.
"""
