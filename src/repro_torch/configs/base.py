"""Base configuration objects for architectures and input shapes, the port's
copy of ``repro/configs/base.py`` (pure dataclasses, field for field).

Every architecture is a ``ModelConfig``; the four input shapes are
``ShapeSpec`` entries in ``SHAPES``. The port builds dense models from
``reduced()`` variants, or at a config's published widths with its depth cut.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (superset across all 6 families)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation for the config values
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer flavour ---
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    pos_embed: str = "rope"  # rope | learned (whisper decoder)
    max_position: int = 1_048_576  # only used for learned pos-embed tables

    # --- attention pattern ---
    attn_type: str = "full"  # full | sliding | none
    sliding_window: int = 4096
    logit_softcap: float = 0.0  # gemma-style attn-logit soft capping (0 = off)

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss coefficient

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)

    # --- hybrid (RG-LRU / Griffin) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0

    # --- VLM ---
    cross_attn_every: int = 0  # every Nth decoder layer is a cross-attn layer
    n_vision_tokens: int = 0
    vision_dim: int = 0  # dim of (stub) projected vision embeddings

    # --- audio encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 0

    # --- numerics / schedule ---
    dtype: str = "bfloat16"
    lr_schedule: str = "cosine"  # cosine | wsd (minicpm)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank if self.dt_rank else max(1, -(-self.d_model // 16))

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # token embedding
        if not self.tie_embeddings:
            n += d * v  # lm head
        if self.pos_embed == "learned":
            n += min(self.max_position, 1 << 16) * d

        def attn_params() -> int:
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            return d * qd + 2 * d * kvd + qd * d + 2 * d  # q,k,v,o + 2 norms

        def mlp_params(dff: int) -> int:
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            return mult * d * dff

        def moe_params() -> int:
            p = d * self.n_experts  # router
            p += self.n_experts * mlp_params(self.d_ff_expert)
            p += self.n_shared_experts * mlp_params(self.d_ff_expert)
            return p

        def mamba_params() -> int:
            di, ns, dtr = self.d_inner, self.ssm_state, self.dt_rank_eff
            p = d * 2 * di          # in_proj (x and z branches)
            p += di * self.d_conv   # depthwise conv
            p += di * (dtr + 2 * ns)  # x -> (dt, B, C) projection
            p += dtr * di           # dt_proj
            p += di * ns + di       # A_log, D
            p += di * d + d         # out_proj + norm
            return p

        def rglru_params() -> int:
            w = self.lru_width
            p = 2 * d * w           # two input branches
            p += w * self.d_conv    # temporal conv
            p += 2 * w * w // 1     # recurrence + input gates (block-diag approx -> full here)
            p += w                  # Lambda
            p += w * d + 2 * d      # out proj + norms
            return p

        if self.family == "moe":
            per_layer = attn_params() + moe_params()
            n += self.n_layers * per_layer
        elif self.family == "ssm":
            n += self.n_layers * mamba_params()
        elif self.family == "hybrid":
            pat = self.block_pattern or ("rglru",)
            n_attn = sum(1 for i in range(self.n_layers) if pat[i % len(pat)] == "attn")
            n_rec = self.n_layers - n_attn
            n += n_attn * (attn_params() + mlp_params(self.d_ff))
            n += n_rec * (rglru_params() + mlp_params(self.d_ff))
        elif self.family == "vlm":
            n_cross = self.n_layers // max(1, self.cross_attn_every)
            n_self = self.n_layers - n_cross
            per = attn_params() + mlp_params(self.d_ff)
            # cross layers: extra kv proj from vision dim + gates
            cross_extra = 2 * self.vision_dim * self.n_kv_heads * self.head_dim
            n += n_self * per + n_cross * (per + cross_extra)
        elif self.family == "audio":
            per_enc = attn_params() + mlp_params(self.d_ff)
            per_dec = 2 * attn_params() + mlp_params(self.d_ff)  # self + cross
            n += self.n_encoder_layers * per_enc + self.n_layers * per_dec
        else:  # dense
            n += self.n_layers * (attn_params() + mlp_params(self.d_ff))
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2

        def attn_params() -> int:
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            return d * qd + 2 * d * kvd + qd * d + 2 * d

        per_layer = attn_params() + d * self.n_experts
        per_layer += (self.moe_top_k + self.n_shared_experts) * mult * d * self.d_ff_expert
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n + self.n_layers * per_layer

    def reduced(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests.

        2 layers (or one block-pattern period), d_model<=512, <=4 experts.
        """
        pat = self.block_pattern
        n_layers = len(pat) if pat else 2
        if self.family == "vlm":
            n_layers = max(2, self.cross_attn_every)  # one self-run + one cross
        d_model = min(self.d_model, 128)
        head_dim = 32
        n_heads = max(2, d_model // head_dim)
        n_kv = 1 if self.n_kv_heads == 1 else max(1, min(self.n_kv_heads, n_heads // 2))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=4 * d_model,
            d_ff_expert=(2 * d_model if self.n_experts else 0),
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            vocab_size=min(self.vocab_size, 512),
            lru_width=(d_model if self.lru_width else 0),
            ssm_state=min(self.ssm_state, 8),
            expand=2,
            sliding_window=min(self.sliding_window, 64),
            n_encoder_layers=(2 if self.is_encoder_decoder else 0),
            n_audio_frames=(16 if self.n_audio_frames else 0),
            n_vision_tokens=(16 if self.n_vision_tokens else 0),
            vision_dim=(d_model if self.vision_dim else 0),
            cross_attn_every=(2 if self.cross_attn_every else 0),
            dtype="float32",
            max_position=4096,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    sliding_window_decode: bool = False  # force sliding-window cache (long_500k)


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1, sliding_window_decode=True),
}

LONG_CONTEXT_WINDOW = 8_192  # sliding-window cache size used for long_500k decode
