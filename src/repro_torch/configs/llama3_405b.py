"""Llama-3-405B [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        source="arXiv:2407.21783",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128_256,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=500_000.0,
    )
