"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families: parameters,
prefill, decode step, cache.

Counterpart of ``repro.models.transformer``. A dense or MoE layer is
rms_norm -> QKV -> RoPE -> attention -> wo -> residual ->
rms_norm -> FFN -> residual, the FFN SwiGLU (dense) or the routed experts of
``models.moe`` (moe). An ssm layer is rms_norm -> Mamba2 mixer
(``models.ssm``) -> residual. A hybrid (Hymba) layer runs attention and the
Mamba2 mixer in parallel on one normed input, adds the mean of their
normed outputs, then the SwiGLU FFN; its attention is sliding-window except
on ``global_attn_layers``. A vlm is a dense LM whose sequence starts with the
request's P patch embeddings, projected by ``patch_proj``. Then the final
norm and the (tied) LM head. The norms, the two attentions, the expert
products and the SSD scan go through ``kernels.ops``, so on CUDA they run
the hand-written kernels; the other projections are ``torch.matmul``.

Layer-stacked parameters are ``[L, ...]`` tensors, sliced per layer (the
JAX code scans over them). The decode step updates the attention caches
and the SSM state in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import moe, ssm
from repro_torch.models.attention import cache_write_decode, promote
from repro_torch.models.common import ParamSpec, empty_tree, tree_map
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


def block_template(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "ssm": ssm.param_template(cfg)}
    block: Dict[str, Any] = {
        "norm1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_template(cfg),
        "norm2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.family == "moe":
        block["moe"] = moe.param_template(cfg)
    else:
        block["mlp"] = mlp_template(cfg)
    if cfg.family == "hybrid":
        block["ssm"] = ssm.param_template(cfg)
        block["attn_out_norm"] = ParamSpec((cfg.d_model,), ("embed",), init="ones")
        block["ssm_out_norm"] = ParamSpec((cfg.d_model,), ("embed",), init="ones")
    return block


def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    t: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed"),
        "blocks": tree_map(lambda s: s.with_layers(cfg.num_layers), block_template(cfg)),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.family == "vlm":
        t["patch_proj"] = ParamSpec((cfg.d_model, cfg.d_model), ("embed", None))
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


def attn_full(x, ap, cfg: ModelConfig, *, window: int = 0):
    """Full-sequence attention. x [B,S,D] -> (out [B,S,D], k, v rotated)."""
    bsz, s, _ = x.shape
    q, k, v = _qkv(x, ap, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    return out.reshape(bsz, s, -1) @ ap["wo"], k, v


def attn_decode(x, ap, cfg: ModelConfig, kc, vc, sp, pos, *, window: int = 0, ring: bool = False):
    """One-token attention. x [B,D]; kc/vc [B,S,K,dh] and sp [B,S] updated in place."""
    q, k, v = _qkv(x, ap, cfg)  # [B, H, dh] / [B, K, dh]
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    cache_write_decode(kc, vc, sp, k, v, pos, ring=ring)
    out = ops.decode_attention(q, kc, vc, sp, pos, window=window)
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


def _mix(h, a_out, s_out, bp, cfg: ModelConfig):
    """The hybrid residual: h + 0.5 * (norm(attention) + norm(SSM))."""
    a_out = ops.rmsnorm(a_out, bp["attn_out_norm"], eps=cfg.norm_eps)
    s_out = ops.rmsnorm(s_out, bp["ssm_out_norm"], eps=cfg.norm_eps)
    return h + 0.5 * (a_out + s_out)


def block_full(h, bp, cfg: ModelConfig, *, layer_window: int = 0, prompt_lens=None):
    """h [B,S,D] -> (h, the layer's cache pieces, aux).

    The cache pieces are the rotated keys and values ``k``, ``v`` (attention
    families) and the final SSM state ``ssm`` (ssm, hybrid); aux is the MoE
    aux loss (None otherwise). MoE routes in groups of 1024 tokens, the
    reference's default."""
    if cfg.family == "ssm":
        y, state = ssm.apply_ssm(ops.rmsnorm(h, bp["norm"], eps=cfg.norm_eps), bp["ssm"], cfg,
                                 prompt_lens)
        return h + y, {"ssm": state}, None
    x = ops.rmsnorm(h, bp["norm1"], eps=cfg.norm_eps)
    a_out, k, v = attn_full(x, bp["attn"], cfg, window=layer_window)
    cache: Dict[str, Any] = {"k": k, "v": v}
    if cfg.family == "hybrid":
        s_out, cache["ssm"] = ssm.apply_ssm(x, bp["ssm"], cfg, prompt_lens)
        h = _mix(h, a_out, s_out, bp, cfg)
    else:
        h = h + a_out
    h, aux = _ffn(h, bp, cfg, group_size=1024)
    return h, cache, aux


def block_decode(h, bp, cfg: ModelConfig, layer_cache: Dict[str, Any], pos, *,
                 layer_window: int = 0, ring: bool = False):
    """h [B,D] -> (h, the layer's new SSM state or None). ``layer_cache`` holds the
    layer's attention cache (``k``, ``v``, ``slot_pos``, updated in place) and/or
    its SSM state ``ssm``.

    MoE routes the batch as one group (capacity 8 at 4 slots), as the reference does."""
    if cfg.family == "ssm":
        y, state = ssm.apply_ssm_decode(ops.rmsnorm(h, bp["norm"], eps=cfg.norm_eps),
                                        layer_cache["ssm"], bp["ssm"], cfg)
        return h + y, state
    x = ops.rmsnorm(h, bp["norm1"], eps=cfg.norm_eps)
    a_out = attn_decode(x, bp["attn"], cfg, layer_cache["k"], layer_cache["v"],
                        layer_cache["slot_pos"], pos, window=layer_window, ring=ring)
    state = None
    if cfg.family == "hybrid":
        s_out, state = ssm.apply_ssm_decode(x, layer_cache["ssm"], bp["ssm"], cfg)
        h = _mix(h, a_out, s_out, bp, cfg)
    else:
        h = h + a_out
    return _ffn(h, bp, cfg, group_size=h.shape[0])[0], state


def _layer_window(cfg: ModelConfig, idx: int) -> int:
    """The attention window of layer ``idx``: the sliding window on a hybrid's
    non-global layers, else 0 (full attention)."""
    if cfg.family == "hybrid" and cfg.sliding_window:
        return 0 if idx in cfg.global_attn_layers else cfg.sliding_window
    return 0


# ---------------------------------------------------------------------------
# Full-model forward (hidden states)
# ---------------------------------------------------------------------------
def forward_hidden(params, tokens, cfg: ModelConfig, *, collect_cache: bool = False,
                   prompt_lens=None, patches=None
                   ) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]], torch.Tensor]:
    """tokens [B,S_text] -> (final-normed h [B,S,D], per-layer cache pieces (see
    ``block_full``) or None, aux): aux is the MoE aux loss averaged over layers
    (0 for the other families). ``prompt_lens`` [B] reaches every SSM mixer. For
    vlm, ``patches`` [B,P,D] are projected and prepended (S = P + S_text)."""
    h = embed_tokens(tokens, params["embed"])
    if cfg.family == "vlm":
        if patches is None or patches.dim() != 3 or patches.shape[1] != cfg.num_patches:
            raise ValueError(f"a vlm needs its patch embeddings: pass patches=[B, "
                             f"{cfg.num_patches}, {cfg.d_model}] (P = cfg.num_patches)")
        h = torch.cat([patches.to(h.dtype) @ params["patch_proj"], h], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: Optional[List[Dict[str, Any]]] = [] if collect_cache else None
    for i in range(cfg.num_layers):
        h, cache, a = block_full(h, layer_slice(params["blocks"], i), cfg,
                                 layer_window=_layer_window(cfg, i), prompt_lens=prompt_lens)
        if a is not None:
            aux = aux + a / cfg.num_layers
        if caches is not None:
            caches.append(cache)
    return ops.rmsnorm(h, params["final_norm"], eps=cfg.norm_eps), caches, aux


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------
def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """ParamSpec tree of the decode cache; axes name the batch dim for ``insert_slot``.

    dense/moe/vlm: ``attn`` [L, B, S, ...] (a vlm's S counts its patches).
    hybrid: ``attn_global`` [n_glob, B, S, ...] and ``attn_sliding``
    [n_slide, B, w, ...], a ring of w = min(window, S) slots. ssm/hybrid: ``ssm`` h [L, B, H, P, N] float32 and conv_buf
    [L, B, wc-1, conv_ch]."""
    dh, k, L = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_layers

    def kv(layers: int, s: int, seq_ax: str) -> Dict[str, ParamSpec]:
        axes = ("layers", "batch", seq_ax, "kv_heads", None)
        return {"k": ParamSpec((layers, batch, s, k, dh), axes),
                "v": ParamSpec((layers, batch, s, k, dh), axes),
                "slot_pos": ParamSpec((layers, batch, s), ("layers", "batch", seq_ax),
                                      dtype="int32")}

    spec: Dict[str, Any] = {"pos": ParamSpec((batch,), ("batch",), dtype="int32")}
    if cfg.family in ("dense", "moe", "vlm"):
        spec["attn"] = kv(L, cache_len, "cache_seq")
    if cfg.family == "hybrid":
        n_glob = len(cfg.global_attn_layers)
        spec["attn_global"] = kv(n_glob, cache_len, "cache_seq")
        spec["attn_sliding"] = kv(L - n_glob, min(cfg.sliding_window, cache_len), "window")
    if cfg.family in ("ssm", "hybrid"):
        spec["ssm"] = {
            "h": ParamSpec((L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           ("layers", "batch", None, None, "ssm_state"), dtype="float32"),
            "conv_buf": ParamSpec((L, batch, cfg.ssm_conv_dim - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                  ("layers", "batch", None, None)),
        }
    return spec


def empty_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zero K/V and SSM state, ``slot_pos`` = -1 (empty), ``pos`` = 0; K/V in bf16."""
    return empty_tree(cache_spec(cfg, batch, cache_len), device, CACHE_DTYPE)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def _sliding_ring(prompt_lens: torch.Tensor, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather index [B, w], slot_pos [B, w]) of a prompt's trailing window in a ring.

    Ring slot r of row b holds position t = plen_b - 1 - ((plen_b - 1 - r) mod w),
    the one of the prompt's last w positions with t = r (mod w); where t < 0
    the slot is empty (-1) and holds the padded position t + w (< w <= S)."""
    r = torch.arange(w, device=prompt_lens.device)[None, :]
    last = prompt_lens.long()[:, None] - 1
    t = last - torch.remainder(last - r, w)
    return torch.where(t >= 0, t, t + w), torch.where(t >= 0, t, -1).to(torch.int32)


def prefill(params, tokens, prompt_lens, cfg: ModelConfig, *, patches=None):
    """Forward the prompt, build the decode cache, return last-token logits.

    tokens [B, S] padded to S; prompt_lens [B] actual lengths (<= S). The
    cache length is S; slots past a prompt's length are empty (-1).

    A vlm's sequence is its P patches, then the text: the cache has P + S
    slots, of which the first P + prompt_len are valid, and ``pos`` is
    P + prompt_len, the position of the next token. The reference sets ``pos``
    to prompt_len (``repro/models/transformer.py:449``), so its first decode
    step rotates by, and overwrites the slot of, a position inside the prompt.

    A hybrid's sliding layers keep each prompt's trailing window
    (``_sliding_ring``). The reference (``repro/models/transformer.py:466-474``)
    keeps the last w positions of the padded sequence instead, which loses the
    prompt positions before S - w when the prompt is shorter than S > w; the
    two agree exactly when every prompt fills S or when S <= w.
    """
    bsz = tokens.shape[0]
    L = cfg.num_layers
    h, caches, _ = forward_hidden(params, tokens, cfg, collect_cache=True,
                                  prompt_lens=prompt_lens, patches=patches)
    s = h.shape[1]
    n_patch = s - tokens.shape[1]               # P for a vlm, else 0
    valid_lens = prompt_lens + n_patch
    last = torch.clamp(prompt_lens - 1, min=0).long() + n_patch
    h_last = h[torch.arange(bsz, device=h.device), last]
    logits = (h_last @ lm_head_weight(params, cfg)).float()

    ar = torch.arange(s, device=tokens.device)[None, :]
    slot_pos = torch.where(ar < valid_lens[:, None], ar, -1).to(torch.int32)

    def stack(key, layers, fn=lambda t: t):
        return torch.stack([fn(caches[i][key]) for i in layers])

    cache: Dict[str, Any] = {"pos": valid_lens.to(torch.int32)}
    if cfg.family in ("dense", "moe", "vlm"):
        cache["attn"] = {"k": stack("k", range(L)), "v": stack("v", range(L)),
                         "slot_pos": slot_pos[None].repeat(L, 1, 1)}
    if cfg.family == "hybrid":
        glob = [i for i in range(L) if i in cfg.global_attn_layers]
        slide = [i for i in range(L) if i not in cfg.global_attn_layers]
        if glob:
            cache["attn_global"] = {"k": stack("k", glob), "v": stack("v", glob),
                                    "slot_pos": slot_pos[None].repeat(len(glob), 1, 1)}
        if slide:
            idx, ring_pos = _sliding_ring(prompt_lens, min(cfg.sliding_window, s))
            take = lambda t: torch.gather(t, 1, idx[:, :, None, None].expand(-1, -1, *t.shape[2:]))
            cache["attn_sliding"] = {"k": stack("k", slide, take), "v": stack("v", slide, take),
                                     "slot_pos": ring_pos[None].repeat(len(slide), 1, 1)}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = {"h": stack("ssm", range(L), lambda st: st.h),
                        "conv_buf": stack("ssm", range(L), lambda st: st.conv_buf)}
    return logits, cache


def decode_step(params, cache: Dict[str, Any], tokens, cfg: ModelConfig):
    """One decode step. tokens [B] -> (logits [B,V] f32, cache).

    The attention caches' K/V/slot_pos and the SSM state ``h`` are written in
    place; the SSM ``conv_buf`` is rebuilt, its dtype promoted with the new
    inputs' as in the reference. ``pos`` advances by one for every row,
    occupied or not, as in the reference.
    """
    pos = cache["pos"]
    h = embed_tokens(tokens, params["embed"])
    has_ssm = cfg.family in ("ssm", "hybrid")
    conv_out = []
    n_glob = n_slide = 0
    for i in range(cfg.num_layers):
        lw = _layer_window(cfg, i)
        lc: Dict[str, Any] = {}
        ring = False
        if cfg.family in ("dense", "moe", "vlm"):
            att, j = cache["attn"], i
        elif cfg.family == "hybrid" and lw:
            att, j, ring = cache["attn_sliding"], n_slide, True
            n_slide += 1
        elif cfg.family == "hybrid":
            att, j = cache["attn_global"], n_glob
            n_glob += 1
        else:
            att = None
        if att is not None:
            lc.update(k=att["k"][j], v=att["v"][j], slot_pos=att["slot_pos"][j])
        if has_ssm:
            lc["ssm"] = ssm.SSMState(cache["ssm"]["h"][i], cache["ssm"]["conv_buf"][i])
        h, state = block_decode(h, layer_slice(params["blocks"], i), cfg, lc, pos,
                                layer_window=lw, ring=ring)
        if has_ssm:
            cache["ssm"]["h"][i].copy_(state.h)
            conv_out.append(state.conv_buf)
    if has_ssm:
        cache["ssm"] = {"h": cache["ssm"]["h"], "conv_buf": torch.stack(conv_out)}
    h = ops.rmsnorm(h, params["final_norm"], eps=cfg.norm_eps)
    logits = (h @ lm_head_weight(params, cfg)).float()
    cache["pos"] = pos + 1
    return logits, cache
