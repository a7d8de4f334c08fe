"""Llama-3.2-11B-Vision language backbone [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is a
gated cross-attention layer over (stubbed) vision patch embeddings.
The ViT/projector frontend is a STUB per the assignment: input_specs() provides
precomputed projected patch embeddings of shape (batch, 1601, 4096).
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128_256,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        rope_theta=500_000.0,
        cross_attn_every=5,
        n_vision_tokens=1601,
        vision_dim=4096,
    )
