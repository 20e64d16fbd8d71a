"""MusicGen medium — decoder-only LM over EnCodec tokens (backbone only;
codec frontend is the allowed stub). [arXiv:2306.05284]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", arch_type="audio",
        num_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048, n_codebooks=4,
        norm="layernorm", activation="gelu",
        long_context_mode="swa",
        source="arXiv:2306.05284",
    )
