"""StableLM-2 12B — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", arch_type="dense",
        num_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab_size=100352,
        norm="layernorm",
        long_context_mode="swa",        # serving-only ring-buffer window
        source="hf:stabilityai/stablelm-2-1_6b",
    )
