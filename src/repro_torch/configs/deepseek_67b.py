"""deepseek-67b: dense llama-arch LM [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "deepseek-67b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        head_dim=128,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=3,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        d_ff=344,
        vocab_size=512,
        head_dim=16,
        rope_theta=10000.0,
    )
