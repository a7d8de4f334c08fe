"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Block pattern: (RG-LRU, RG-LRU, local-attention), local window 2048.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        source="arXiv:2402.19427",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        mlp_type="geglu",
        norm_type="rmsnorm",
        tie_embeddings=True,
        block_pattern=("rglru", "rglru", "attn"),
        lru_width=2560,
        attn_type="sliding",
        sliding_window=2048,
    )
