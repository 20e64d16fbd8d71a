"""Qwen2.5 14B — dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", arch_type="dense",
        num_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0,
        long_context_mode="swa",
        source="hf:Qwen/Qwen2.5-0.5B",
    )
