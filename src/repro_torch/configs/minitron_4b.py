"""Minitron 4B — width/depth-pruned Nemotron dense decoder. [arXiv:2407.14679]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", arch_type="dense",
        num_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab_size=256000,
        activation="gelu",
        long_context_mode="swa",
        source="arXiv:2407.14679",
    )
