"""StableLM-2 1.6B — dense MHA decoder. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", arch_type="dense",
        num_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        norm="layernorm",
        long_context_mode="swa",
        source="hf:stabilityai/stablelm-2-1_6b",
    )
