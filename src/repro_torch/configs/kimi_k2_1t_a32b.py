"""Kimi-K2 (1T total / 32B active) [arXiv:2501.kimi2, paper-table].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 routed experts top-8 + 1 shared expert.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        source="arXiv:2501.kimi2",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        d_ff_expert=2048,
        n_experts=384,
        n_shared_experts=1,
        moe_top_k=8,
        vocab_size=163_840,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000.0,
        capacity_factor=1.25,
    )
