"""Whisper-base transformer backbone [arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865.
The mel-spectrogram + conv frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings (batch, 1500, 512).
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        source="arXiv:2212.04356",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51_865,
        mlp_type="gelu",
        norm_type="layernorm",
        use_rope=False,
        pos_embed="learned",
        is_encoder_decoder=True,
        n_encoder_layers=6,
        n_audio_frames=1500,
        max_position=1 << 16,
    )
