"""StableLM-2-12B [hf:stabilityai/stablelm-2-12b family].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        source="hf:stabilityai/stablelm-2-12b",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab_size=100_352,
        mlp_type="swiglu",
        norm_type="layernorm",
    )
