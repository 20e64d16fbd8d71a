"""The Fulcrum engine's kernels in CUDA C++ for sm_90a, the first two
ported from the Pallas package ``repro.kernels.fulcrum``:

 * ``maxplus_scan`` — the managed-interleaving recurrence
   ``c_k = max(c_{k-1}, ready_k) + e_k`` fused with the training
   slack-fill count (``csrc/maxplus_scan.cu``);
 * ``lane_sort`` — the per-lane padded sort behind the batched report
   builder, with per-lane budget-violation counts (``csrc/lane_sort.cu``);
 * ``fused_window`` — one fleet window of every device (plan ladder,
   admission, compaction, the max-plus fold) as one launch
   (``csrc/fused_window.cu``); its reference is a ``jax.jit`` program.

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version for CPU tensors, and counts its launches in ``<wrapper>.launches``.
Import them from their modules (``...fulcrum.maxplus_scan``); the package
does not re-export them, so each module name stays the module.
"""
