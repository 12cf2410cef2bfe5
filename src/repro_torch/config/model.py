"""Model configuration for the dense decoder family.

A copy of the fields of ``repro.config.model.ModelConfig`` that the dense
family reads (llama-style: RMSNorm, SwiGLU, RoPE, GQA). The port keeps its
own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

FAMILIES = ("dense",)


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description. All sizes are in elements, not bytes."""

    name: str
    family: str

    num_layers: int
    d_model: int
    num_heads: int            # query heads
    num_kv_heads: int         # KV heads for GQA (== num_heads for MHA)
    d_ff: int                 # SwiGLU hidden dim
    vocab_size: int

    head_dim: int = 0         # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def _attn_params(self) -> int:
        dh = self.resolved_head_dim
        q = self.d_model * self.num_heads * dh
        kv = 2 * self.d_model * self.num_kv_heads * dh
        o = self.num_heads * dh * self.d_model
        bias = (self.num_heads + 2 * self.num_kv_heads) * dh if self.qkv_bias else 0
        return q + kv + o + bias

    def layer_params(self) -> int:
        """Parameters in one block: attention, SwiGLU and the two norms."""
        return self._attn_params() + 3 * self.d_model * self.d_ff + 2 * self.d_model

    def num_params(self) -> int:
        """Total parameter count N."""
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return self.num_layers * self.layer_params() + embed + head + self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def validate(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: {FAMILIES}")
    if cfg.num_heads <= 0 or cfg.num_kv_heads <= 0:
        raise ValueError("dense models need query and KV heads")
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError("GQA requires num_heads % num_kv_heads == 0")
