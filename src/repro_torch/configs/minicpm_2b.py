"""MiniCPM-2B [arXiv:2404.06395].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753, llama-like arch,
trained with the WSD (warmup-stable-decay) schedule — wired to optim/schedules.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        source="arXiv:2404.06395",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab_size=122_753,
        mlp_type="swiglu",
        norm_type="rmsnorm",
        tie_embeddings=True,
        lr_schedule="wsd",
    )
