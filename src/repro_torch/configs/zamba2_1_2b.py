"""Zamba2 1.2B — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", arch_type="hybrid",
        num_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, attn_every=6,
        long_context_mode="swa",        # shared-attn blocks use a serve window
        source="arXiv:2411.15242",
    )
