"""internvl2-76b: VLM = InternViT frontend (STUB) + LM backbone
[arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 (llama-3-70b-style
backbone). The vision tower is a stub: the caller passes precomputed patch embeddings
[B, num_patches, d_model] (``prefill(..., patches=)``), which the backbone
projects and prepends to the token embeddings.
"""
from repro_torch.config import ModelConfig

ARCH_ID = "internvl2-76b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        head_dim=128,
        rope_theta=500000.0,
        num_patches=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        d_ff=320,
        vocab_size=512,
        head_dim=16,
        num_patches=8,
    )
