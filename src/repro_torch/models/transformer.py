"""Decoder-only LM, dense and MoE families: parameters, prefill, decode step, cache.

Counterpart of ``repro.models.transformer`` for ``family`` "dense" and
"moe". Per layer: rms_norm -> QKV -> RoPE -> attention -> wo -> residual ->
rms_norm -> FFN -> residual; then the final norm and the (tied) LM head. The
FFN is SwiGLU (dense) or the routed experts of ``models.moe`` (moe). The
norm, the two attentions and the expert products go through
``kernels.ops``, so on CUDA they run the hand-written kernels; the other
projections are ``torch.matmul``.

Layer-stacked parameters are ``[L, ...]`` tensors, sliced per layer (the
JAX code scans over them). The decode step updates the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.attention import cache_write_decode, promote
from repro_torch.models.common import ParamSpec, resolve_device, torch_dtype, tree_map
from repro_torch.models.layers import apply_rope, embed_tokens, swiglu

# The decode cache's K/V dtype whatever the model dtype, as in the reference
# (``cache_spec`` leaves carry no dtype and ``empty_cache`` defaults to bf16).
CACHE_DTYPE = "bfloat16"


# ---------------------------------------------------------------------------
# Parameter templates
# ---------------------------------------------------------------------------
def attn_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    t = {
        "wq": ParamSpec((d, hq * dh), ("embed", "heads")),
        "wk": ParamSpec((d, hk * dh), ("embed", "kv_heads")),
        "wv": ParamSpec((d, hk * dh), ("embed", "kv_heads")),
        "wo": ParamSpec((hq * dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((hq * dh,), ("heads",), init="zeros")
        t["bk"] = ParamSpec((hk * dh,), ("kv_heads",), init="zeros")
        t["bv"] = ParamSpec((hk * dh,), ("kv_heads",), init="zeros")
    return t


def mlp_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    block = {
        "norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_template(cfg),
        "norm2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.family == "moe":
        block["moe"] = moe.param_template(cfg)
    else:
        block["mlp"] = mlp_template(cfg)
    t: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed"),
        "blocks": tree_map(lambda s: s.with_layers(cfg.num_layers), block),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return t


def lm_head_weight(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def layer_slice(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    return tree_map(lambda x: x[i], blocks)


# ---------------------------------------------------------------------------
# Attention and block bodies
# ---------------------------------------------------------------------------
def _qkv(x, ap, cfg: ModelConfig):
    lead = x.shape[:-1]
    dh = cfg.resolved_head_dim
    q, k, v = x @ ap["wq"], x @ ap["wk"], x @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    return (q.reshape(*lead, cfg.num_heads, dh), k.reshape(*lead, cfg.num_kv_heads, dh),
            v.reshape(*lead, cfg.num_kv_heads, dh))


def attn_full(x, ap, cfg: ModelConfig):
    """Full-sequence attention. x [B,S,D] -> (out [B,S,D], k, v rotated)."""
    bsz, s, _ = x.shape
    q, k, v = _qkv(x, ap, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True)
    return out.reshape(bsz, s, -1) @ ap["wo"], k, v


def attn_decode(x, ap, cfg: ModelConfig, kc, vc, sp, pos):
    """One-token attention. x [B,D]; kc/vc [B,S,K,dh] and sp [B,S] updated in place."""
    q, k, v = _qkv(x, ap, cfg)  # [B, H, dh] / [B, K, dh]
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    cache_write_decode(kc, vc, sp, k, v, pos, ring=False)
    out = ops.decode_attention(q, kc, vc, sp, pos)
    # a bf16 cache under f32 weights gives a bf16 output; jnp promotes it
    out, wo = promote(out.reshape(out.shape[0], -1), ap["wo"])
    return out @ wo


def _ffn(h, bp, cfg: ModelConfig, group_size: int):
    """h + FFN(rms_norm(h)) and the layer's MoE aux loss (None for dense)."""
    x2 = ops.rmsnorm(h, bp["norm2"], eps=cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe.apply_moe(x2, bp["moe"], cfg, group_size=group_size)
        return h + y, aux
    return h + swiglu(x2, bp["mlp"]["w_gate"], bp["mlp"]["w_up"], bp["mlp"]["w_down"]), None


def block_full(h, bp, cfg: ModelConfig):
    """h [B,S,D] -> (h, k, v, aux) with k, v the layer's rotated keys and values
    and aux the MoE aux loss (None for dense).

    MoE routes in groups of 1024 tokens, the reference's default."""
    a_out, k, v = attn_full(ops.rmsnorm(h, bp["norm1"], eps=cfg.norm_eps), bp["attn"], cfg)
    h, aux = _ffn(h + a_out, bp, cfg, group_size=1024)
    return h, k, v, aux


def block_decode(h, bp, cfg: ModelConfig, kc, vc, sp, pos):
    """h [B,D] -> h; the layer's cache (kc, vc, sp) is updated in place.

    MoE routes the batch as one group (capacity 8 at 4 slots), as the reference does."""
    x = ops.rmsnorm(h, bp["norm1"], eps=cfg.norm_eps)
    h = h + attn_decode(x, bp["attn"], cfg, kc, vc, sp, pos)
    return _ffn(h, bp, cfg, group_size=h.shape[0])[0]


# ---------------------------------------------------------------------------
# Full-model forward (hidden states)
# ---------------------------------------------------------------------------
def forward_hidden(params, tokens, cfg: ModelConfig, *, collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], torch.Tensor]:
    """tokens [B,S] -> (final-normed h [B,S,D], {"k", "v": [L,B,S,Hkv,dh]} or None,
    aux): aux is the MoE aux loss averaged over layers (0 for dense)."""
    h = embed_tokens(tokens, params["embed"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = None
    if collect_cache:
        b, s = tokens.shape
        shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        # written layer by layer, in place of the reference's stacked scan output
        caches = {"k": torch.empty(shape, dtype=h.dtype, device=h.device),
                  "v": torch.empty(shape, dtype=h.dtype, device=h.device)}
    for i in range(cfg.num_layers):
        h, k, v, a = block_full(h, layer_slice(params["blocks"], i), cfg)
        if a is not None:
            aux = aux + a / cfg.num_layers
        if caches is not None:
            caches["k"][i], caches["v"][i] = k, v
    return ops.rmsnorm(h, params["final_norm"], eps=cfg.norm_eps), caches, aux


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """ParamSpec tree of the decode cache; axes name the batch dim for ``insert_slot``."""
    dh, k, L = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_layers
    kv_axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    return {
        "pos": ParamSpec((batch,), ("batch",), dtype="int32"),
        "attn": {
            "k": ParamSpec((L, batch, cache_len, k, dh), kv_axes),
            "v": ParamSpec((L, batch, cache_len, k, dh), kv_axes),
            "slot_pos": ParamSpec((L, batch, cache_len), ("layers", "batch", "cache_seq"),
                                  dtype="int32"),
        },
    }


def empty_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zero K/V, ``slot_pos`` = -1 (empty), ``pos`` = 0."""
    dev = resolve_device(device)

    def mk(s: ParamSpec):
        dt = torch_dtype(s.dtype or CACHE_DTYPE)
        if s.dtype == "int32":
            return torch.full(s.shape, -1 if len(s.shape) >= 3 else 0, dtype=dt, device=dev)
        return torch.zeros(s.shape, dtype=dt, device=dev)

    return tree_map(mk, cache_spec(cfg, batch, cache_len))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def prefill(params, tokens, prompt_lens, cfg: ModelConfig):
    """Forward the prompt, build the decode cache, return last-token logits.

    tokens [B, S] padded to S; prompt_lens [B] actual lengths (<= S). The
    cache length is S; slots past a prompt's length are empty (-1).
    """
    _, s = tokens.shape
    h, caches, _ = forward_hidden(params, tokens, cfg, collect_cache=True)
    last = torch.clamp(prompt_lens - 1, min=0).long()
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    logits = (h_last @ lm_head_weight(params, cfg)).float()

    ar = torch.arange(s, device=tokens.device)[None, :]
    slot_pos = torch.where(ar < prompt_lens[:, None], ar, -1).to(torch.int32)
    cache = {
        "pos": prompt_lens.to(torch.int32),
        "attn": {"k": caches["k"], "v": caches["v"],
                 "slot_pos": slot_pos[None].repeat(cfg.num_layers, 1, 1)},
    }
    return logits, cache


def decode_step(params, cache: Dict[str, Any], tokens, cfg: ModelConfig):
    """One decode step. tokens [B] -> (logits [B,V] f32, cache).

    The cache's K/V/slot_pos are written in place and ``pos`` advances by one
    for every row, occupied or not, as in the reference.
    """
    pos = cache["pos"]
    att = cache["attn"]
    h = embed_tokens(tokens, params["embed"])
    for i in range(cfg.num_layers):
        h = block_decode(h, layer_slice(params["blocks"], i), cfg,
                         att["k"][i], att["v"][i], att["slot_pos"][i], pos)
    h = ops.rmsnorm(h, params["final_norm"], eps=cfg.norm_eps)
    logits = (h @ lm_head_weight(params, cfg)).float()
    cache["pos"] = pos + 1
    return logits, cache
