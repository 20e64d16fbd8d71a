"""Mixtral 8x22B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", arch_type="moe",
        num_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, top_k=2,
        sliding_window=8192,            # SWA (paper §2)
        long_context_mode="native",     # SWA is native sub-quadratic serving
        source="arXiv:2401.04088",
    )
