"""Snowflake Arctic 480B — 128-expert top-2 MoE with dense residual branch.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", arch_type="moe",
        num_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        n_experts=128, top_k=2, moe_dense_residual=True,
        long_context_mode="swa",
        source="hf:Snowflake/snowflake-arctic-base",
    )
