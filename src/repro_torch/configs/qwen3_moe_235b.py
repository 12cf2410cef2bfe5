"""qwen3-moe-235b-a22b: MoE LM, 128 experts top-8 [hf:Qwen/Qwen3].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936.
head_dim=128 (decoupled from d_model/num_heads as in Qwen3). The full
config does not fit one card; the port runs its smoke config on the CPU.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=1536,
        vocab_size=151936,
        head_dim=128,
        num_experts=128,
        experts_per_token=8,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=48,
        vocab_size=256,
        head_dim=16,
        num_experts=8,
        experts_per_token=2,
    )
