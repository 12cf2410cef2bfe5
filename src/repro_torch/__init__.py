"""PyTorch/CUDA port of the LM serving stack of ``repro``, for one NVIDIA H100.

Mirrors the JAX package's module names (``config``, ``configs``, ``models``,
``kernels``, ``serving``) and imports nothing of it: the JAX package stays
the reference the tests compare against. The norm, the two attentions and
the MoE expert products run hand-written CUDA kernels (``csrc/``) on CUDA
tensors and their plain PyTorch versions on CPU tensors. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
