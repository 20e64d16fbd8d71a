"""Mamba2 780M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", arch_type="ssm",
        num_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64,
        long_context_mode="native",     # O(1) recurrent state
        source="arXiv:2405.21060",
    )
