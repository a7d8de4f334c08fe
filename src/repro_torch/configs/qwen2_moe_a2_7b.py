"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936,
MoE 60 routed experts top-4 + 4 shared experts.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        d_ff_expert=1408,
        n_experts=60,
        n_shared_experts=4,
        moe_top_k=4,
        vocab_size=151_936,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000.0,
    )
