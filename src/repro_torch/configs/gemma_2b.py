"""Gemma-2B [arXiv:2403.08295].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU, head_dim=256,
tied embeddings.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        source="arXiv:2403.08295",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
        mlp_type="geglu",
        norm_type="rmsnorm",
        tie_embeddings=True,
    )
