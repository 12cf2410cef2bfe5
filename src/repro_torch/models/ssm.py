"""Mamba2 (SSD, state-space duality) block: chunked prefill and O(1) decode.

Counterpart of ``repro.models.ssm``. The full-sequence body runs the SSD
chunked scan through ``ops.ssd`` (the CUDA kernel on CUDA tensors, the
float32 ``ssd_chunked`` port on CPU tensors) and its gated norm through
``ops.rmsnorm``; the one-token decode body is plain torch ops, as the
reference's is plain jnp. Every cast of the reference is kept, so that a
bf16 run rounds where the reference rounds.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import promote
from repro_torch.models.common import ParamSpec, resolve_device


def param_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, d_in = cfg.d_model, cfg.d_inner
    h, n, wc = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_dim
    conv_ch = d_in + 2 * n  # x, B, C channels (ngroups = 1)
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * n + h), ("embed", "ssm_in")),
        "conv_w": ParamSpec((wc, conv_ch), (None, "ssm_in")),
        "conv_b": ParamSpec((conv_ch,), ("ssm_in",), init="zeros"),
        "A_log": ParamSpec((h,), (None,), init="ssm_a", dtype="float32"),
        "D": ParamSpec((h,), (None,), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros", dtype="float32"),
        "norm": ParamSpec((d_in,), ("ssm_in",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("ssm_in", "embed")),
    }


class SSMState(NamedTuple):
    """Decode-time recurrent state of one layer (or a layer stack).

    h          [B, H, P, N]        SSD state, float32
    conv_buf   [B, wc-1, conv_ch]  trailing raw conv inputs
    """

    h: torch.Tensor
    conv_buf: torch.Tensor


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [wc, C]: float32 sums in tap
    order, cast to x's dtype. A DTensor runs it on local shards, batch and channels
    sharded as they come and S whole (``ops.on_shards``): torch 2.11's DTensor
    cannot pad a sharded [B, S, C]."""
    if isinstance(x, DTensor):
        bc = {"b": 0, "c": 2}
        return ops.on_shards(_causal_conv, (x, w, b), (bc, {"c": 1}, {"c": 0}), (bc,))
    wc, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, wc - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(wc):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, n = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n], zxbcdt[..., 2 * d_in + 2 * n:]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """rms_norm(y * silu(z)), silu in float32 and cast to y's dtype first."""
    return ops.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"], eps=cfg.norm_eps)


def apply_ssm(x_in: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
              prompt_lens: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence SSM block body (prefill). x_in [B, S, D] -> (y [B, S, D], final state).

    ``prompt_lens`` [B] (right-padded prefill): positions at or past a row's
    prompt length get dt = 0, so x*dt = 0 and the log decay is 0: the state
    passes through the padding unchanged and the final state is the state
    after exactly ``prompt_lens`` real tokens. S is padded to a multiple of
    the chunk with zeros, which leave the state untouched as well.
    """
    bsz, s, _ = x_in.shape
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    wc = cfg.ssm_conv_dim

    z, xbc_raw, dt_raw = _split_proj(cfg, x_in @ p["in_proj"])
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(bsz, s, h, cfg.ssm_head_dim)
    b_mat, c_mat = xbc[..., d_in:d_in + n], xbc[..., d_in + n:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # [B, S, H]
    if prompt_lens is not None:
        valid = torch.arange(s, device=x_in.device)[None, :] < prompt_lens[:, None]
        dt = dt * valid.float()[..., None]
    log_decay = dt * -torch.exp(p["A_log"])                          # [B, S, H]

    pad = (-s) % cfg.ssm_chunk
    xdt = xs * dt[..., None].to(xs.dtype)
    ld, bm, cm = log_decay, b_mat, c_mat
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        ld = F.pad(ld, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    y, final = ops.ssd(xdt.contiguous(), ld.contiguous(), bm.contiguous(), cm.contiguous(),
                       chunk=cfg.ssm_chunk)
    y = y[:, :s]
    y = y + (p["D"][:, None] * xs.float()).to(y.dtype)
    y = _gated_norm(y.reshape(bsz, s, d_in), z, p, cfg)
    out = y @ p["out_proj"]

    # per-row trailing window: raw conv inputs at plen-(wc-1) .. plen-1, zeros before 0
    lens = (torch.full((bsz,), s, device=x_in.device) if prompt_lens is None
            else prompt_lens.long())
    idx = lens[:, None] - (wc - 1) + torch.arange(wc - 1, device=x_in.device)
    ok = idx >= 0
    idx = idx.clamp(0, s - 1)
    conv_buf = torch.gather(xbc_raw, 1, idx[..., None].expand(-1, -1, xbc_raw.shape[-1]))
    conv_buf = conv_buf.masked_fill(~ok[..., None], 0)
    return out, SSMState(h=final, conv_buf=conv_buf)


def apply_ssm_decode(x_in: torch.Tensor, state: SSMState, p: Dict[str, torch.Tensor],
                     cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """One token. x_in [B, D]; state h [B, H, P, N], conv_buf [B, wc-1, C] ->
    (y [B, D], the new state). The conv buffer's dtype promotes with the new
    input's, as ``jnp.concatenate`` does (a float32 model's bf16 cache buffer
    becomes float32 after one step)."""
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    z, xbc_raw, dt_raw = _split_proj(cfg, x_in @ p["in_proj"])
    hist = torch.cat(promote(state.conv_buf, xbc_raw[:, None]), dim=1)     # [B, wc, C]
    conv = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float())
    xbc = F.silu(conv + p["conv_b"].float()).to(x_in.dtype)

    xs = xbc[..., :d_in].reshape(-1, h, cfg.ssm_head_dim)
    b_mat, c_mat = xbc[..., d_in:d_in + n].float(), xbc[..., d_in + n:].float()

    dt = F.softplus(dt_raw.float() + p["dt_bias"])                         # [B, H]
    decay = torch.exp(dt * -torch.exp(p["A_log"]))

    dx = xs.float() * dt[..., None]                                        # [B, H, P]
    h_new = state.h * decay[..., None, None] + torch.einsum("bhp,bn->bhpn", dx, b_mat)
    y = torch.einsum("bhpn,bn->bhp", h_new, c_mat)
    y = y + p["D"][:, None] * xs.float()
    y = _gated_norm(y.reshape(-1, d_in).to(x_in.dtype), z, p, cfg)
    out = y @ p["out_proj"]

    conv_buf = torch.cat(promote(state.conv_buf[:, 1:], xbc_raw[:, None]), dim=1)
    return out, SSMState(h=h_new, conv_buf=conv_buf)


def init_state(cfg: ModelConfig, batch: int, num_layers: Optional[int] = None,
               device="cuda") -> SSMState:
    """Zero decode state (h float32, conv_buf bf16) on ``device`` (the card
    unless the caller asks for the CPU); leaves are layer-stacked if
    ``num_layers`` is given."""
    device = resolve_device(device)
    lead = (batch,) if num_layers is None else (num_layers, batch)
    h = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    cbuf = (cfg.ssm_conv_dim - 1, cfg.d_inner + 2 * cfg.ssm_state)
    return SSMState(h=torch.zeros(lead + h, dtype=torch.float32, device=device),
                    conv_buf=torch.zeros(lead + cbuf, dtype=torch.bfloat16, device=device))
