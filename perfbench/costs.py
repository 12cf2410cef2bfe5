"""The yardstick's arithmetic: the card's published peaks, each kernel call's
operations and bytes, and a model's FLOPs.

The kernel costs are a frozen copy of the program's ``kernels/*.py`` ``cost`` and
``backward_cost`` (each input read once, each output written once), taken at the
call's own inputs: a decode call counts the (row, slot) pairs its masks allow and a
``moe_gmm`` call its live rows and the experts that have one, where the program's
shape-level count takes every slot, row and expert. A call's bound is the larger of
its bytes over the HBM bandwidth and its operations over the card's peak for the type
of its operands (``Cost.op_type``; bf16 for the seven kernels here, as the cells run
them), whatever path the kernel takes: a kernel that moves onto faster units reads
closer to its bound, never past it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


class Cost(NamedTuple):
    flops: float
    bytes: float
    op_type: str = "bfloat16"          # the type of the call's operands, a key of PEAK_FLOPS

    def bound_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / PEAK_FLOPS[self.op_type])


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask allows over s positions."""
    return s * (s + 1) // 2


def allowed_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo + 1, 0, None).sum())


# --- kernels: (shape, element size, the counts the inputs give) -> Cost -------------
def rmsnorm(numel: int, d: int, esize: int) -> Cost:
    return Cost(4.0 * numel, float((2 * numel + d) * esize))


def rmsnorm_backward(numel: int, d: int, esize: int) -> Cost:
    return Cost(8.0 * numel, float((3 * numel + 2 * d) * esize))


def flash_attention(b: int, sq: int, sk: int, hq: int, hkv: int, dh: int, esize: int,
                    causal: bool, window: int) -> Cost:
    flops = 4.0 * b * hq * dh * allowed_pairs(sq, sk, causal, window)
    return Cost(flops, float((2 * sq * hq + 2 * sk * hkv) * b * dh * esize))


def flash_attention_backward(b: int, sq: int, sk: int, hq: int, hkv: int, dh: int, esize: int,
                             causal: bool, window: int) -> Cost:
    flops = 8.0 * b * hq * dh * allowed_pairs(sq, sk, causal, window)
    return Cost(flops, float((4 * sq * hq + 4 * sk * hkv) * b * dh * esize + 4 * b * hq * sq))


def decode_attention(b: int, s: int, hq: int, hkv: int, dh: int, q_esize: int, c_esize: int,
                     valid: int, rows_without: int) -> Cost:
    """``valid``: the (row, slot) pairs the masks allow; ``rows_without``: rows with none
    (their output is V's mean over the S slots)."""
    nbytes = ((2 * valid + s * rows_without) * hkv * dh * c_esize
              + b * hq * dh * (q_esize + c_esize) + (b * s + b) * 4)
    return Cost(4.0 * hq * dh * valid + hkv * dh * s * rows_without, float(nbytes))


def moe_gmm(e: int, r: int, d: int, f: int, esize: int, rows: int, experts: int) -> Cost:
    """``rows``: live rows over all experts; ``experts``: the experts with one."""
    return Cost(2.0 * rows * d * f, float((rows * d + experts * d * f + e * r * f) * esize))


def moe_gmm_backward(e: int, r: int, d: int, f: int, esize: int, rows: int, experts: int) -> Cost:
    return Cost(4.0 * rows * d * f,
                float((rows * (d + f) + experts * d * f + e * r * d + e * d * f) * esize))


# --- model FLOPs (no recompute, no padding) ----------------------------------------
def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product per token: attention, the SwiGLU (an MoE
    layer's router and its top-k experts), and the LM head."""
    d, dh = int(cfg["hidden_size"]), int(cfg["head_dim"])
    hq, hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    f = int(cfg["intermediate_size"])
    attn = d * hq * dh + 2 * d * hk * dh + hq * dh * d
    e = int(cfg.get("num_experts", 0))
    if e:
        ffn = d * e + int(cfg["num_experts_per_tok"]) * 3 * d * f
    else:
        ffn = 3 * d * f
    return int(cfg["num_hidden_layers"]) * (attn + ffn) + d * int(cfg["vocab_size"])


def attention_flops_per_pair(cfg: dict) -> float:
    """QKᵀ and PV forward, a (query, key) pair in every layer: 4·Hq·dh·L."""
    return 4.0 * int(cfg["num_attention_heads"]) * int(cfg["head_dim"]) * int(cfg["num_hidden_layers"])


def prefill_flops(cfg: dict, prompt_len: int) -> float:
    """A prompt's forward: 2·N per token for every product but the LM head, which the
    prefill takes at the last position only, and its causal pairs."""
    d, v = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    body = matmul_params(cfg) - d * v
    return 2.0 * body * prompt_len + 2.0 * d * v + attention_flops_per_pair(cfg) * causal_pairs(prompt_len)


def decode_flops(cfg: dict, context: int) -> float:
    """One generated token at a context of ``context`` positions (itself included)."""
    return 2.0 * matmul_params(cfg) + attention_flops_per_pair(cfg) * context


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: 6·N_active a token and 12·Hq·dh a causal pair
    and layer (forward 4, backward 8), without the recompute."""
    return (6.0 * matmul_params(cfg) * batch * seq
            + 3.0 * attention_flops_per_pair(cfg) * batch * causal_pairs(seq))
