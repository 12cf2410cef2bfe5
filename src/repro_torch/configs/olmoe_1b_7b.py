"""olmoe-1b-7b: MoE LM, 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (MHA kv=16) d_ff=1024 (per expert) vocab=50304.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "olmoe-1b-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        head_dim=128,
        num_experts=64,
        experts_per_token=8,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=32,
        vocab_size=256,
        head_dim=16,
        num_experts=8,
        experts_per_token=2,
    )
