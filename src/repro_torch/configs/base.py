"""Config system of the port: the architecture registry, reduced variants
and seeded batches.

Counterpart of ``repro.configs.base``. The port registers every
configuration of the reference: the dense, moe, ssm, hybrid, vlm and audio
families. ``make_batch`` draws from an explicit
``torch.Generator`` (the reference draws from a ``jax.random`` key, so the
two give different values for one seed; tests hand both packages the same
NumPy-made batch instead).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.model import ModelConfig

#: Configurations the port runs: the reference's ``ARCH_IDS``, in its order.
ARCH_IDS = [
    "mixtral-8x22b", "stablelm-12b", "arctic-480b", "qwen2.5-14b",
    "zamba2-1.2b", "musicgen-medium", "stablelm-1.6b", "internvl2-1b",
    "mamba2-780m", "minitron-4b",
]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; the port "
                         f"registers {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.config()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = max(1, min(cfg.n_kv_heads, n_heads)) if cfg.n_heads else 0
    if cfg.n_heads and cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads                                   # keep MHA archs MHA
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=256,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64 if cfg.n_heads else 0,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_multiple=128,
        n_experts=min(cfg.n_experts, 4),
        moe_group_size=128,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_chunk=32,
        attn_every=2,
        n_patches=16,
        d_vision=64,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        serve_window=64,
        remat=False,
    )


def batch_shapes(cfg: ModelConfig, seq_len: int, batch: int,
                 kind: str) -> dict:
    """``{name: (shape, dtype)}`` of one model-input batch, in the
    reference's order (``batch_struct``): ``tokens`` (B, S) and, for
    ``kind="train"``, ``labels``; ``kind="decode"`` gives (B, 1). Audio
    tokens carry a last axis of ``n_codebooks``; a vlm prompt of
    ``seq_len`` positions is ``n_patches`` bf16 vision embeddings
    (``vision``, (B, n_patches, d_vision)) followed by ``seq_len -
    n_patches`` text tokens."""
    i32 = torch.int32
    if kind == "decode":
        cb = (cfg.n_codebooks,) if cfg.arch_type == "audio" else ()
        return {"tokens": ((batch, 1) + cb, i32)}
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    if cfg.arch_type == "audio":
        tok = ((batch, seq_len, cfg.n_codebooks), i32)
        out = {"tokens": tok}
    elif cfg.arch_type == "vlm":
        if seq_len <= cfg.n_patches:
            raise ValueError(
                f"a {cfg.name} sequence of {seq_len} positions holds no "
                f"text: its first {cfg.n_patches} positions are vision "
                f"patches, so seq_len must exceed {cfg.n_patches}")
        tok = ((batch, seq_len - cfg.n_patches), i32)
        out = {"tokens": tok, "vision": (
            (batch, cfg.n_patches, cfg.d_vision), torch.bfloat16)}
    else:
        tok = ((batch, seq_len), i32)
        out = {"tokens": tok}
    if kind == "train":
        out["labels"] = tok
    return out


def make_batch(cfg: ModelConfig, seq_len: int, batch: int, kind: str,
               generator: torch.Generator) -> dict:
    """Random batch of ``batch_shapes`` on the generator's device: token
    ids uniform in the vocabulary, vision embeddings drawn normal in
    float32 and cast to bf16."""
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, seq_len, batch,
                                             kind).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator, dtype=dtype,
                                      device=generator.device)
        else:
            out[name] = torch.randn(shape, generator=generator,
                                    dtype=torch.float32,
                                    device=generator.device).to(dtype)
    return out
