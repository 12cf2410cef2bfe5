"""whisper-base: encoder-decoder audio transformer [arXiv:2212.04356].

6L d_model=512 8H d_ff=2048 vocab=51865. The conv frontend is a stub:
the caller passes precomputed frame embeddings [B, encoder_frames, d_model]
(``prefill(..., frames=)``); the encoder transformer stack and the full
decoder (self-attn + cross-attn, KV cache) are real.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "whisper-base"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encdec",
        num_layers=6,          # decoder layers
        encoder_layers=6,
        encoder_frames=1500,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        head_dim=64,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        encoder_frames=32,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        tie_embeddings=True,
    )
