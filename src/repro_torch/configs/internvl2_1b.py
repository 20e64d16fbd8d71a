"""InternVL2 1B — InternLM2-style language decoder consuming InternViT patch
embeddings (vision encoder is the allowed stub frontend). [arXiv:2404.16821]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", arch_type="vlm",
        num_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151655,
        n_patches=256, d_vision=1024,
        long_context_mode="swa",
        source="arXiv:2404.16821",
    )
