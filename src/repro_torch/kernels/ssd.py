"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd.cu`` and its plain versions.

Counterpart of ``repro.kernels.ssd_scan`` (the kernel), of
``repro.models.ssm.ssd_chunked`` (``plain``) and of
``repro.kernels.ref.ssd_sequential`` (``sequential``, the O(S) recurrence
that defines the semantics, for the tests). x [B, S, H, P] is dt-weighted,
a [B, S, H] is the float32 log decay, b and c [B, S, N] are shared across
heads. ``ssd`` launches the kernel on CUDA tensors and raises on anything
else; like the Pallas kernel it takes no initial state and needs S to be a
multiple of ``min(chunk, S)``.

The kernel is chunk-parallel: a chunk pass writes every chunk's state
contribution and C·Bᵀ, a state pass carries the states across chunks, and an
output pass forms y, each in float32 workspaces that ``workspaces`` allocates.
``chunked_reference`` is that computation in plain float32 PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd", "plain", "sequential", "chunked_reference", "workspaces", "launches",
           "MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

MAX_CHUNK = 128     # kMaxL in the source
MAX_HEAD_DIM = 64   # kMaxP
MAX_STATE = 128     # kMaxN
NEG_INF = -1e30

_ENTRY = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}


def plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int,
          h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in float32: (y [B, S, H, P] in x's dtype, final state [B, H, P, N] f32).

    The intra-chunk quadratic dual form, with the [P, N] state carried across
    chunks in a loop, as ``ssd_chunked`` scans."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd: S = {s} is not a multiple of chunk = {chunk}")
    nc, l = s // chunk, chunk
    xc = x.float().reshape(bsz, nc, l, h, p)
    ac = a.float().reshape(bsz, nc, l, h).transpose(2, 3)      # [B, nc, H, l]
    bc = b.float().reshape(bsz, nc, l, n)
    cc = c.float().reshape(bsz, nc, l, n)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    ys = []
    for i in range(nc):
        xl, bl, cl = xc[:, i], bc[:, i], cc[:, i]
        cum = ac[:, i].cumsum(dim=-1)                          # [B, H, l]
        seg = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(torch.where(tri, seg, NEG_INF))          # [B, H, l, l]
        scores = torch.einsum("bln,bsn->bls", cl, bl)          # [B, l, l]
        y_diag = torch.einsum("bhls,bshp->blhp", L * scores[:, None], xl)
        y_off = torch.einsum("bln,bhpn->blhp", cl, state) * torch.exp(cum).transpose(1, 2)[..., None]
        decay_states = torch.exp(cum[..., -1:] - cum)          # [B, H, l]
        new = torch.einsum("bhlp,bln->bhpn", xl.transpose(1, 2) * decay_states[..., None], bl)
        state = state * torch.exp(cum[..., -1])[..., None, None] + new
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(bsz, s, h, p), state


def sequential(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(S) recurrence h_t = exp(a_t) h_{t-1} + x_tᵀ b_t, y_t = h_t c_t, in float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(a[:, t].float())                     # [B, H]
        upd = torch.einsum("bhp,bn->bhpn", x[:, t].float(), b[:, t].float())
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state


def workspaces(bsz: int, s: int, h: int, p: int, n: int, l: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's float32 workspaces for chunks of ``l``: the chunk states
    [B, nc, H, P, N] (each chunk's contribution, then the state entering it), C·Bᵀ
    [B, nc, l, l] (row j, column i, zero for j > i) and the chunk decays
    cum_last [B, nc, H]."""
    nc = s // l
    return (torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=device),
            torch.empty((bsz, nc, l, l), dtype=torch.float32, device=device),
            torch.empty((bsz, nc, h), dtype=torch.float32, device=device))


def chunked_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      chunk: int, ws: Optional[Tuple[torch.Tensor, ...]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three passes in float32 PyTorch, with its workspace layout
    (``ws``, as ``workspaces`` makes them, is filled as the kernel fills it):
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"ssd: S = {s} is not a multiple of chunk = {l}")
    nc = s // l
    states, cb, decay = ws if ws is not None else workspaces(bsz, s, h, p, n, l, x.device)
    xc = x.float().reshape(bsz, nc, l, h, p)
    cum = a.float().reshape(bsz, nc, l, h).cumsum(dim=2)                  # [B, nc, l, H]
    bc, cc = b.float().reshape(bsz, nc, l, n), c.float().reshape(bsz, nc, l, n)
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()   # [i, j]: j <= i
    # 1. chunk pass: decays, state contributions, and C·Bᵀ once per chunk (transposed)
    decay.copy_(cum[:, :, -1])
    states.copy_(torch.einsum("bclhp,bcln->bchpn",
                              xc * torch.exp(decay[:, :, None] - cum)[..., None], bc))
    cb.copy_((torch.einsum("bcin,bcjn->bcij", cc, bc) * tri).transpose(2, 3))
    # 2. state pass: states[:, c] <- the state entering chunk c
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    for i in range(nc):
        contrib = states[:, i].clone()
        states[:, i] = state
        state = state * torch.exp(decay[:, i])[..., None, None] + contrib
    # 3. output pass
    seg = cum.transpose(2, 3)[..., :, None] - cum.transpose(2, 3)[..., None, :]  # [B, nc, H, i, j]
    L = torch.exp(torch.where(tri, seg, NEG_INF))
    y_diag = torch.einsum("bcji,bchij,bcjhp->bcihp", cb, L, xc)
    y_off = torch.einsum("bcin,bchpn->bcihp", cc, states) * torch.exp(cum)[..., None]
    return (y_diag + y_off).reshape(bsz, s, h, p).to(x.dtype), state


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
        chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P]; a [B, S, H] float32; b, c [B, S, N] of x's dtype ->
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    global launches
    _build.check_inputs("ssd", x.device, x=x, a=a, b=b, c=c)
    _build.require(x.dtype in _ENTRY, f"ssd: dtype {x.dtype} not supported")
    _build.require(a.dtype == torch.float32, "ssd: a must be float32")
    _build.require(b.dtype == x.dtype and c.dtype == x.dtype, "ssd: b and c must have x's dtype")
    _build.require(x.dim() == 4 and b.dim() == 3, "ssd: x [B,S,H,P], a [B,S,H], b/c [B,S,N]")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    _build.require(tuple(a.shape) == (bsz, s, h) and tuple(b.shape) == (bsz, s, n)
                   and c.shape == b.shape, "ssd: a, b, c shapes disagree with x")
    l = min(chunk, s)
    _build.require(l > 0 and s % l == 0, f"ssd: S = {s} is not a multiple of min(chunk, S) = {l}")
    _build.require(l <= MAX_CHUNK and 0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE,
                   f"ssd: needs chunk <= {MAX_CHUNK}, P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}")
    _build.require(bsz <= 65535 and h < 65535 and x.numel() < 2**62, "ssd: batch too large")
    y = torch.empty_like(x)
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ws = workspaces(bsz, s, h, p, n, l, x.device)
    fn = getattr(_build.library("ssd"), _ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                    hf.data_ptr(), *(t.data_ptr() for t in ws), bsz, s, h, p, n, l,
                    _build.stream(x.device)), "ssd")
    launches += 1
    return y, hf
