"""glm4-9b: dense LM with RoPE + aggressive GQA [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "glm4-9b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        head_dim=128,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=384,
        head_dim=12,
    )
