"""qwen2.5-32b: dense LM with GQA and QKV bias [hf:Qwen/Qwen2.5].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "qwen2.5-32b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=80,
        num_heads=10,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=384,
        head_dim=8,
        qkv_bias=True,
    )
