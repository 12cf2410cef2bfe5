"""Model configuration for every architecture family.

A copy of ``repro.config.model.ModelConfig`` for every family:

  dense  -- decoder-only transformer (llama-style: RMSNorm, SwiGLU, RoPE, GQA)
  moe    -- the dense skeleton with a top-k routed MoE FFN in place of SwiGLU
  ssm    -- attention-free Mamba2 (SSD) stack
  hybrid -- Hymba-style parallel attention + SSM heads per block
  encdec -- Whisper-style encoder-decoder (the conv frontend is a stub: frames in)
  vlm    -- InternVL-style: patch embeddings projected and prepended to a dense LM

The port keeps its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description. All sizes are in elements, not bytes."""

    name: str
    family: str

    num_layers: int
    d_model: int
    num_heads: int            # query heads (0 for attention-free)
    num_kv_heads: int         # KV heads for GQA (== num_heads for MHA)
    d_ff: int                 # SwiGLU hidden dim (per-expert dim for MoE)
    vocab_size: int

    head_dim: int = 0         # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert_d_ff: int = 0   # a dense SwiGLU beside the experts; 0 -> none

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0        # per-head state dim N
    ssm_expand: int = 2       # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_conv_dim: int = 4     # depthwise conv kernel width
    ssm_chunk: int = 128      # SSD chunk length

    # --- hybrid (attention + SSM in parallel) ---
    sliding_window: int = 0   # 0 -> full attention
    global_attn_layers: tuple = ()  # layer indices using full attention

    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_frames: int = 1500  # stub frontend output length (audio frames)

    # --- VLM ---
    num_patches: int = 0      # stub frontend output length (image patches)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        """SSM inner dim."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def _attn_params(self) -> int:
        if self.num_heads == 0:
            return 0
        dh = self.resolved_head_dim
        q = self.d_model * self.num_heads * dh
        kv = 2 * self.d_model * self.num_kv_heads * dh
        o = self.num_heads * dh * self.d_model
        bias = (self.num_heads + 2 * self.num_kv_heads) * dh if self.qkv_bias else 0
        return q + kv + o + bias

    def _moe_ffn_params(self) -> int:
        router = self.d_model * self.num_experts
        experts = self.num_experts * 3 * self.d_model * self.d_ff
        shared = 3 * self.d_model * self.shared_expert_d_ff
        return router + experts + shared

    def _ssm_params(self) -> int:
        """The reference's count, which leaves out the conv bias (d_inner + 2N)."""
        d_in, h, n = self.d_inner, self.ssm_heads, self.ssm_state
        in_proj = self.d_model * (2 * d_in + 2 * n + h)   # -> [z, x, B, C, dt] (ngroups = 1)
        conv = self.ssm_conv_dim * (d_in + 2 * n)
        extras = 3 * h                                     # A_log, D, dt_bias
        return in_proj + conv + extras + d_in + d_in * self.d_model   # + norm, out_proj

    def layer_params(self) -> int:
        """Parameters in one block, norms included."""
        if self.family == "ssm":
            return self._ssm_params() + self.d_model      # a single pre-norm
        ffn = self._moe_ffn_params() if self.family == "moe" else 3 * self.d_model * self.d_ff
        n = self._attn_params() + ffn + 2 * self.d_model
        if self.family == "hybrid":
            n += self._ssm_params() + 2 * self.d_model    # the per-branch output norms
        return n

    def num_params(self) -> int:
        """Total parameter count N."""
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if self.family == "encdec":
            ffn, norm = 3 * self.d_model * self.d_ff, self.d_model
            enc_block = self._attn_params() + ffn + 2 * norm
            dec_block = 2 * self._attn_params() + ffn + 3 * norm   # self- and cross-attention
            return (self.encoder_layers * enc_block + self.num_layers * dec_block + embed + head
                    + 2 * norm)
        total = self.num_layers * self.layer_params() + embed + head + self.d_model
        if self.family == "vlm":
            total += self.d_model * self.d_model   # the stub patch projection
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def validate(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: {FAMILIES}")
    if cfg.family != "ssm":
        if cfg.num_heads <= 0 or cfg.num_kv_heads <= 0:
            raise ValueError("models with attention need query and KV heads")
        if cfg.num_heads % cfg.num_kv_heads:
            raise ValueError("GQA requires num_heads % num_kv_heads == 0")
    if cfg.family == "moe" and not (cfg.num_experts > 0 and cfg.experts_per_token > 0):
        raise ValueError("moe models need num_experts > 0 and experts_per_token > 0")
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm_state <= 0:
            raise ValueError("ssm and hybrid models need ssm_state > 0")
        if cfg.d_inner % cfg.ssm_head_dim:
            raise ValueError("d_inner must be a multiple of ssm_head_dim")
    if cfg.family == "encdec" and cfg.encoder_layers <= 0:
        raise ValueError("encdec models need encoder_layers > 0")
