"""hymba-1.5b: hybrid parallel attention + Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention everywhere except three global full-attention
layers (first / middle / last), as in the paper.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "hymba-1.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        sliding_window=1024,
        global_attn_layers=(0, 15, 31),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        head_dim=32,
        ssm_state=8,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=16,
        sliding_window=32,
        global_attn_layers=(0,),
        tie_embeddings=True,
    )
