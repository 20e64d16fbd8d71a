"""Config system of the port: the architecture registry, reduced variants
and seeded batches.

Counterpart of ``repro.configs.base``. The port registers only the
configurations whose model family it runs; asking for another raises and
names the ROADMAP item that ports it. ``make_batch`` draws from an explicit
``torch.Generator`` (the reference draws from a ``jax.random`` key, so the
two give different tokens for one seed; tests hand both packages the same
NumPy-made batch instead).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.model import ModelConfig

#: Configurations the port runs (the reference's ``ARCH_IDS`` lists ten).
ARCH_IDS = ["zamba2-1.2b"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: the port registers "
            f"{ARCH_IDS}; the dense, ssm, moe, vlm and audio families are "
            f"ROADMAP queue 1 item 7")
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


def make_batch(cfg: ModelConfig, seq_len: int, batch: int, kind: str,
               generator: torch.Generator) -> dict:
    """Random token batch on the generator's device: ``tokens`` (B, S) and,
    for ``kind="train"``, ``labels``; ``kind="decode"`` gives (B, 1)."""
    if cfg.arch_type in ("vlm", "audio"):
        raise NotImplementedError(f"{cfg.arch_type} batches are not ported "
                                  f"yet (ROADMAP queue 1 item 7)")
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(kind)
    s = 1 if kind == "decode" else seq_len
    names = ("tokens", "labels") if kind == "train" else ("tokens",)
    return {name: torch.randint(0, cfg.vocab_size, (batch, s),
                                generator=generator, dtype=torch.int32,
                                device=generator.device)
            for name in names}
