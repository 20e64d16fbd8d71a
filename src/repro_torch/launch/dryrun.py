"""The dry run's analytic model: a step's model FLOPs, and the two probe
depths whose measured costs extrapolate linearly to the full depth.

Counterpart of the analytic parts of ``repro.launch.dryrun``. The
reference's ``_compile_once`` and ``collective_bytes`` lower and compile a
step with XLA and read its HLO; they have no torch counterpart. In their
place the dry run's main loop (ROADMAP queue 1 item 8b-iii) is to measure a
sharded step on the cards at the two probe depths, with its NCCL bytes.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape
from repro_torch.models.model import ModelConfig


def analytic_model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for fwd-only (N = active params,
    D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _probe_depths(cfg: ModelConfig) -> tuple[int, int]:
    """Two small depths for per-layer cost extraction; hybrid archs need
    multiples of attn_every so shared-attention sites scale linearly."""
    if cfg.arch_type == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    return 2, 4


def _lin_extrapolate(v1: float, v2: float, l1: int, l2: int, L: int) -> float:
    per_layer = (v2 - v1) / (l2 - l1)
    base = v1 - l1 * per_layer
    return base + L * per_layer
