"""Whisper-style encoder-decoder: parameters, encoder, prefill, decode step, cache.

Counterpart of ``repro.models.encdec`` (all of it but ``train_loss``). The
conv frontend is a stub: the inputs are precomputed frame embeddings
[B, F, d_model], F = ``cfg.encoder_frames``. Encoder layers are LayerNorm ->
bidirectional self-attention -> residual -> LayerNorm -> GELU MLP ->
residual; decoder layers add a causal self-attention with a KV cache and a
cross-attention over the encoder's states, whose K/V the prefill computes
once into the cache. Positions are additive sinusoids (no RoPE), the logits
use the tied ``embed.T``. Q, V and O have biases, K has none.

Every attention goes through ``kernels.ops``: the encoder's and the
cross-attention's prefill as non-causal flash (the cross one with Sq != Sk),
the decoder's prefill as causal flash, and both decode attentions as the
decode kernel, the cross one over all F slots (``slot_pos`` 0, ``cur_pos``
0). The LayerNorms and GELU MLPs are plain PyTorch: the reference has no
kernel for them. Decoder layers are a list, ``dec_blocks/0/...``, as in the
reference's tree. The decode step writes the self-attention cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import cache_write_decode
from repro_torch.models.common import ParamSpec, empty_tree
from repro_torch.models.layers import embed_tokens, gelu_mlp, layer_norm, sinusoidal_positions


# ---------------------------------------------------------------------------
# Parameter template
# ---------------------------------------------------------------------------
def _ln(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def _attn_t(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, hd), ("embed", "heads")),
        "bq": ParamSpec((hd,), ("heads",), init="zeros"),
        "wk": ParamSpec((d, hd), ("embed", "heads")),
        "wv": ParamSpec((d, hd), ("embed", "heads")),
        "bv": ParamSpec((hd,), ("heads",), init="zeros"),
        "wo": ParamSpec((hd, d), ("heads", "embed")),
        "bo": ParamSpec((d,), ("embed",), init="zeros"),
    }


def _mlp_t(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_in": ParamSpec((d, f), ("embed", "ffn")),
            "b_in": ParamSpec((f,), ("ffn",), init="zeros"),
            "w_out": ParamSpec((f, d), ("ffn", "embed")),
            "b_out": ParamSpec((d,), ("embed",), init="zeros")}


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    enc_block = lambda: {"ln1": _ln(d), "attn": _attn_t(cfg), "ln2": _ln(d), "mlp": _mlp_t(cfg)}
    dec_block = lambda: {"ln1": _ln(d), "self_attn": _attn_t(cfg),
                         "ln2": _ln(d), "cross_attn": _attn_t(cfg),
                         "ln3": _ln(d), "mlp": _mlp_t(cfg)}
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"), init="embed"),
        "enc_blocks": [enc_block() for _ in range(cfg.encoder_layers)],
        "enc_final": _ln(d),
        "dec_blocks": [dec_block() for _ in range(cfg.num_layers)],
        "dec_final": _ln(d),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _norm(x, p, cfg: ModelConfig):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _mlp(x, p):
    return gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def _heads(x, cfg: ModelConfig):
    return x.reshape(*x.shape[:-1], cfg.num_heads, cfg.resolved_head_dim)


def _q(x, ap, cfg: ModelConfig):
    return _heads(x @ ap["wq"] + ap["bq"], cfg)


def _kv(src, ap, cfg: ModelConfig):
    return _heads(src @ ap["wk"], cfg), _heads(src @ ap["wv"] + ap["bv"], cfg)


def _out(o, ap):
    return o.reshape(*o.shape[:-2], -1) @ ap["wo"] + ap["bo"]


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B,F,D] (stub frontend output) -> encoder states [B,F,D]."""
    h = frames + sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
    for bp in params["enc_blocks"]:
        x = _norm(h, bp["ln1"], cfg)
        o = ops.flash_attention(_q(x, bp["attn"], cfg), *_kv(x, bp["attn"], cfg), causal=False)
        h = h + _out(o, bp["attn"])
        h = h + _mlp(_norm(h, bp["ln2"], cfg), bp["mlp"])
    return _norm(h, params["enc_final"], cfg)


def _decoder_full(params, tokens, enc_out, cfg: ModelConfig):
    """tokens [B,S] over enc_out [B,F,D] -> (final-normed h [B,S,D], per-layer
    self K/V and cross K/V)."""
    h = embed_tokens(tokens, params["embed"])
    h = h + sinusoidal_positions(tokens.shape[1], cfg.d_model, h.device).to(h.dtype)
    caches: List[Dict[str, torch.Tensor]] = []
    for bp in params["dec_blocks"]:
        x = _norm(h, bp["ln1"], cfg)
        k, v = _kv(x, bp["self_attn"], cfg)
        h = h + _out(ops.flash_attention(_q(x, bp["self_attn"], cfg), k, v, causal=True),
                     bp["self_attn"])
        x2 = _norm(h, bp["ln2"], cfg)
        ck, cv = _kv(enc_out, bp["cross_attn"], cfg)
        h = h + _out(ops.flash_attention(_q(x2, bp["cross_attn"], cfg), ck, cv, causal=False),
                     bp["cross_attn"])
        h = h + _mlp(_norm(h, bp["ln3"], cfg), bp["mlp"])
        caches.append({"k": k, "v": v, "cross_k": ck, "cross_v": cv})
    return _norm(h, params["dec_final"], cfg), caches


# ---------------------------------------------------------------------------
# Cache, prefill, decode
# ---------------------------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """``attn``: the decoder's self-attention cache [L, B, cache_len, H, dh];
    ``cross``: the encoder's K/V per decoder layer [L, B, F, H, dh]."""
    dh, hh, L, f = cfg.resolved_head_dim, cfg.num_heads, cfg.num_layers, cfg.encoder_frames
    kv_axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    cross_axes = ("layers", "batch", None, "kv_heads", None)
    return {
        "pos": ParamSpec((batch,), ("batch",), dtype="int32"),
        "attn": {"k": ParamSpec((L, batch, cache_len, hh, dh), kv_axes),
                 "v": ParamSpec((L, batch, cache_len, hh, dh), kv_axes),
                 "slot_pos": ParamSpec((L, batch, cache_len), ("layers", "batch", "cache_seq"),
                                       dtype="int32")},
        "cross": {"k": ParamSpec((L, batch, f, hh, dh), cross_axes),
                  "v": ParamSpec((L, batch, f, hh, dh), cross_axes)},
    }


def empty_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zero K/V in the model's dtype, as the reference's ``ModelApi.init_cache``
    allocates them; ``slot_pos`` = -1 (empty), ``pos`` = 0."""
    return empty_tree(cache_spec(cfg, batch, cache_len), device, cfg.dtype)


def prefill(params, tokens, prompt_lens, cfg: ModelConfig, *, frames=None):
    """Encoder + decoder prompt pass -> (last-token logits [B,V] float32, cache).

    tokens [B, S] padded to the self cache's length S; prompt_lens [B];
    frames [B, F, D] in the model's dtype, F = ``cfg.encoder_frames`` (the
    cross cache's fixed length). Other frame counts are refused here; the
    reference accepts them and fails later, where the batcher writes the
    cache into its slot."""
    if frames is None:
        raise ValueError("an encdec prefill needs its frame embeddings: pass frames=[B, F, D]")
    if frames.dim() != 3 or frames.shape[1] != cfg.encoder_frames:
        raise ValueError(f"frames must be [B, {cfg.encoder_frames}, {cfg.d_model}] (F = "
                         f"cfg.encoder_frames, the cross cache's length); got {tuple(frames.shape)}")
    if frames.dtype != params["embed"].dtype:
        raise ValueError(f"frames must have the model's dtype {params['embed'].dtype}; "
                         f"got {frames.dtype}")
    b, s = tokens.shape
    h, caches = _decoder_full(params, tokens, encode(params, frames, cfg), cfg)
    last = torch.clamp(prompt_lens - 1, min=0).long()
    logits = (h[torch.arange(b, device=h.device), last] @ params["embed"].T).float()

    ar = torch.arange(s, device=tokens.device)[None, :]
    slot = torch.where(ar < prompt_lens[:, None], ar, -1).to(torch.int32)
    stack = lambda key: torch.stack([c[key] for c in caches])
    cache = {
        "pos": prompt_lens.to(torch.int32),
        "attn": {"k": stack("k"), "v": stack("v"),
                 "slot_pos": slot[None].repeat(cfg.num_layers, 1, 1)},
        "cross": {"k": stack("cross_k"), "v": stack("cross_v")},
    }
    return logits, cache


def decode_step(params, cache: Dict[str, Any], tokens, cfg: ModelConfig):
    """One decode step. tokens [B] -> (logits [B,V] float32, cache).

    The new token's position embedding is row min(pos, S-1) of a table as
    long as the self cache, S; its K/V go to slot min(pos, S-1) in place.
    ``pos`` advances by one for every row."""
    pos = cache["pos"]
    b = tokens.shape[0]
    att, cross = cache["attn"], cache["cross"]
    s = att["k"].shape[2]
    h = embed_tokens(tokens, params["embed"])
    pe = sinusoidal_positions(s, cfg.d_model, h.device)
    h = h + pe[torch.clamp(pos, max=s - 1).long()].to(h.dtype)
    no_pos = torch.zeros((b,), dtype=torch.int32, device=h.device)
    all_valid = torch.zeros((b, cross["k"].shape[2]), dtype=torch.int32, device=h.device)
    for i, bp in enumerate(params["dec_blocks"]):
        x = _norm(h, bp["ln1"], cfg)
        k, v = _kv(x, bp["self_attn"], cfg)
        cache_write_decode(att["k"][i], att["v"][i], att["slot_pos"][i], k, v, pos, ring=False)
        o = ops.decode_attention(_q(x, bp["self_attn"], cfg), att["k"][i], att["v"][i],
                                 att["slot_pos"][i], pos)
        h = h + _out(o, bp["self_attn"])
        x2 = _norm(h, bp["ln2"], cfg)
        oc = ops.decode_attention(_q(x2, bp["cross_attn"], cfg), cross["k"][i], cross["v"][i],
                                  all_valid, no_pos)
        h = h + _out(oc, bp["cross_attn"])
        h = h + _mlp(_norm(h, bp["ln3"], cfg), bp["mlp"])
    h = _norm(h, params["dec_final"], cfg)
    logits = (h @ params["embed"].T).float()
    cache["pos"] = pos + 1
    return logits, cache
