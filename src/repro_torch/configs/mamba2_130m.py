"""mamba2-130m: attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060].

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128. d_inner = 2*768 = 1536,
head_dim=64 -> 24 SSM heads. The decode state is O(1) in context length.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "mamba2-130m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_dim=4,
        ssm_chunk=128,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_conv_dim=4,
        ssm_chunk=16,
        tie_embeddings=True,
    )
