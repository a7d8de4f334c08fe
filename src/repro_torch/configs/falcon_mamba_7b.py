"""Falcon-Mamba-7B [arXiv:2410.05355].

64L d_model=4096 attention-free (mamba-1 blocks), ssm_state=16, expand=2,
vocab=65024.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        source="arXiv:2410.05355",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=65_024,
        attn_type="none",
        use_rope=False,
        norm_type="rmsnorm",
        ssm_state=16,
        d_conv=4,
        expand=2,
    )
