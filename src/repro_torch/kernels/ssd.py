"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd.cu`` and its plain versions.

Counterpart of ``repro.kernels.ssd_scan`` (the kernel), of
``repro.models.ssm.ssd_chunked`` (``plain``) and of
``repro.kernels.ref.ssd_sequential`` (``sequential``, the O(S) recurrence
that defines the semantics, for the tests). x [B, S, H, P] is dt-weighted,
a [B, S, H] is the float32 log decay, b and c [B, S, N] are shared across
heads. ``ssd`` launches the kernel on CUDA tensors and raises on anything
else; like the Pallas kernel it takes no initial state and needs S to be a
multiple of ``min(chunk, S)``. On ``meta`` tensors ``ssd`` returns empty
outputs of the kernel's shapes (the dry-run); ``cost`` is the work of one call.

The kernel is chunk-parallel: a chunk pass writes every chunk's state
contribution and C·Bᵀ, a state pass carries the states across chunks, and an
output pass forms y, each in float32 workspaces that ``workspaces`` allocates.
``chunked_reference`` is that computation in plain float32 PyTorch.

The gradient: ``backward`` launches the backward kernel (the same source),
the forward's passes in reverse: the state gradients carried back across the
chunks from the final state's gradient (in the float32 workspace that
``backward_workspaces`` allocates), a chunk pass that forms dx and da, and a
pass that walks the heads on chip and writes db and dc. It reads the states
entering each chunk, C·Bᵀ and the chunk decays that the forward kernel left in
its workspaces. In bf16 its products run on the tensor cores in TF32 (a float32
intermediate among their operands as two TF32 parts, ``tf32_parts``), in float32
on the CUDA cores. ``plain_backward`` is the explicit formula in PyTorch,
``chunked_backward_reference`` the kernel's passes and workspace in float32
PyTorch (with ``tf32=True`` the bf16 kernel's operand rounding),
``backward_cost`` the work of one call. ``SSDFunction`` is the kernel
under autograd: its forward is the kernel (``plain`` on a CPU tensor), which
saves its workspaces, its backward ``backward`` (``plain_backward`` on a CPU
tensor), each backward call a kernel scope of its own for the counters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd", "plain", "cost", "sequential", "chunked_reference", "workspaces", "launches",
           "forward_with_workspaces", "backward", "plain_backward", "chunked_backward_reference",
           "backward_workspaces", "backward_cost", "backward_launches", "SSDFunction",
           "round_tf32", "tf32_parts", "MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)
backward_launches = 0  # backward kernel launches since the last reset

MAX_CHUNK = 128     # kMaxL in the source
MAX_HEAD_DIM = 64   # kMaxP
MAX_STATE = 128     # kMaxN
NEG_INF = -1e30

_ENTRY = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}
_BACKWARD_ENTRY = {torch.float32: "ssd_backward_f32", torch.bfloat16: "ssd_backward_bf16"}


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


def cost(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
         chunk: int) -> _build.Cost:
    """C·Bᵀ once a chunk (shared by the heads), then per (head, chunk) the three
    l·P-sized products (L ⊙ C·Bᵀ)·X, C·hᵀ and Xᵀ·B, the two l x l products on the
    l(l+1)/2 causal pairs only; x, y, b and c in x's dtype and a and the final
    state in float32 read or written once."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    nc = s // l
    flops = bsz * nc * (l * (l + 1.0) * n + h * (l * (l + 1.0) * p + 4.0 * l * p * n))
    nbytes = (2 * bsz * s * h * p + 2 * bsz * s * n) * x.element_size() + (bsz * s * h
                                                                             + bsz * h * p * n) * 4
    return _build.Cost(flops, float(nbytes))


def _check(what: str, x, a, b, c, chunk: int, **more) -> int:
    """Raise on inputs the kernels do not take; the chunk length ``min(chunk, S)``."""
    _build.check_inputs(what, x.device, x=x, a=a, b=b, c=c, **more)
    _build.require(x.dtype in _ENTRY, f"{what}: dtype {x.dtype} not supported")
    _build.require(a.dtype == torch.float32, f"{what}: a must be float32")
    _build.require(b.dtype == x.dtype and c.dtype == x.dtype, f"{what}: b and c must have x's dtype")
    _build.require(x.dim() == 4 and b.dim() == 3, f"{what}: x [B,S,H,P], a [B,S,H], b/c [B,S,N]")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    _build.require(tuple(a.shape) == (bsz, s, h) and tuple(b.shape) == (bsz, s, n)
                   and c.shape == b.shape, f"{what}: a, b, c shapes disagree with x")
    l = min(chunk, s)
    _build.require(l > 0 and s % l == 0, f"{what}: S = {s} is not a multiple of min(chunk, S) = {l}")
    _build.require(l <= MAX_CHUNK and 0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE,
                   f"{what}: needs chunk <= {MAX_CHUNK}, P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}")
    _build.require(bsz <= 65535 and h < 65535 and x.numel() < 2**62, f"{what}: batch too large")
    return l


def forward_with_workspaces(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                            chunk: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The forward kernel: (y, final state, its workspaces (the states entering each
    chunk, C·Bᵀ, the chunk decays), which ``backward`` reads); on ``meta`` tensors
    empty ones."""
    global launches
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    hf_shape = (bsz, h, p, n)
    if x.device.type == "meta":
        l = min(chunk, s)
        return (torch.empty_like(x), torch.empty(hf_shape, dtype=torch.float32, device="meta"),
                workspaces(bsz, s, h, p, n, l, x.device))
    l = _check("ssd", x, a, b, c, chunk)
    y = torch.empty_like(x)
    hf = torch.empty(hf_shape, dtype=torch.float32, device=x.device)
    ws = workspaces(bsz, s, h, p, n, l, x.device)
    fn = getattr(_build.library("ssd"), _ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                    hf.data_ptr(), *(t.data_ptr() for t in ws), bsz, s, h, p, n, l,
                    _build.stream(x.device)), "ssd")
    launches += 1
    return y, hf, ws


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
        chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H, P]; a [B, S, H] float32; b, c [B, S, N] of x's dtype ->
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32)."""
    if x.device.type == "meta":
        return (torch.empty_like(x),
                torch.empty((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]), dtype=torch.float32,
                            device="meta"))
    y, hf, _ = forward_with_workspaces(x, a, b, c, chunk)
    return y, hf


# ----------------------------------------------------------------------------- backward
def plain_backward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   dy: torch.Tensor, dhf: Optional[torch.Tensor], chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``plain(x, a, b, c, min(chunk, S))`` for the gradients ``dy`` of
    y and ``dhf`` of the final state (None: zero), in float32: (dx in x's dtype, da
    float32, db and dc in b's dtype).

    Per chunk, with cum the cumulative log decay, L[i, j] = exp(cum_i - cum_j) for
    j <= i, H the state entering the chunk and G the gradient of the state leaving
    it (carried back: G_c = exp(cum_last)·G_{c+1} + Σ_i exp(cum_i)·dy_iᵀc_i):
    dx_j = Σ_{i>=j} L_ij (c_i·b_j) dy_i + exp(cum_last - cum_j)·G b_j,
    dc_i = Σ_h [Σ_{j<=i} L_ij (dy_i·x_j) b_j + exp(cum_i)·Hᵀdy_i],
    db_j = Σ_h [Σ_{i>=j} L_ij (dy_i·x_j) c_i + exp(cum_last - cum_j)·Gᵀx_j],
    and the gradient of cum_i: the row sum minus the column sum of
    M = L ⊙ C·Bᵀ ⊙ dY·Xᵀ at i, plus exp(cum_i)·dy_i·(H c_i), minus
    exp(cum_last - cum_i)·x_i·(G b_i), plus at the chunk's last step
    exp(cum_last)·<G, H> and Σ_j exp(cum_last - cum_j)·x_j·(G b_j); da is its
    reverse cumulative sum within the chunk."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"ssd: S = {s} is not a multiple of chunk = {l}")
    nc = s // l
    xc = x.float().reshape(bsz, nc, l, h, p)
    dyc = dy.float().reshape(bsz, nc, l, h, p)
    cum = a.float().reshape(bsz, nc, l, h).transpose(2, 3).cumsum(dim=-1)   # [B, nc, H, l]
    bc, cc = b.float().reshape(bsz, nc, l, n), c.float().reshape(bsz, nc, l, n)
    last = cum[..., -1]                                                     # [B, nc, H]
    ecum = torch.exp(cum)
    dec = torch.exp(last[..., None] - cum)                                  # exp(cum_last - cum_j)
    zero = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    # the states entering each chunk, and the gradients of the states leaving each
    contrib = torch.einsum("bclhp,bchl,bcln->bchpn", xc, dec, bc)
    q = torch.einsum("bclhp,bchl,bcln->bchpn", dyc, ecum, cc)
    entering, leaving = [], [None] * nc
    state = zero
    for i in range(nc):
        entering.append(state)
        state = state * torch.exp(last[:, i])[..., None, None] + contrib[:, i]
    grad = zero if dhf is None else dhf.float()
    for i in reversed(range(nc)):
        leaving[i] = grad
        grad = grad * torch.exp(last[:, i])[..., None, None] + q[:, i]
    hs, gs = torch.stack(entering, dim=1), torch.stack(leaving, dim=1)     # [B, nc, H, P, N]

    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()     # [i, j]: j <= i
    L = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], NEG_INF))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    dxy = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)                      # dy_i·x_j
    w = L * cb[:, :, None]
    v = L * dxy
    m = w * dxy
    gb = torch.einsum("bchpn,bcjn->bcjhp", gs, bc)                         # G b_j
    dec_t = dec.transpose(2, 3)                                            # [B, nc, l, H]
    dx = torch.einsum("bchij,bcihp->bcjhp", w, dyc) + gb * dec_t[..., None]
    hty = torch.einsum("bchpn,bcihp->bcihn", hs, dyc)                      # Hᵀ dy_i
    gtx = torch.einsum("bchpn,bcjhp->bcjhn", gs, xc)                       # Gᵀ x_j
    dc = (torch.einsum("bchij,bcjn->bcin", v, bc)
          + torch.einsum("bcihn,bchi->bcin", hty, ecum))
    db = (torch.einsum("bchij,bcin->bcjn", v, cc)
          + torch.einsum("bcjhn,bchj->bcjn", gtx, dec))
    hc = torch.einsum("bchpn,bcin->bchip", hs, cc)                         # H c_i
    t1 = ecum * torch.einsum("bcihp,bchip->bchi", dyc, hc)
    t2 = dec * torch.einsum("bcjhp,bcjhp->bchj", xc, gb)
    dcum = m.sum(dim=-1) - m.sum(dim=-2) + t1 - t2
    dcum[..., -1] += torch.exp(last) * (gs * hs).sum(dim=(-1, -2)) + t2.sum(dim=-1)
    da = dcum.flip(-1).cumsum(dim=-1).flip(-1)                             # [B, nc, H, l]
    return (dx.reshape(bsz, s, h, p).to(x.dtype), da.transpose(2, 3).reshape(bsz, s, h),
            db.reshape(bsz, s, n).to(b.dtype), dc.reshape(bsz, s, n).to(c.dtype))


def backward_workspaces(bsz: int, s: int, h: int, p: int, n: int, l: int, device: torch.device
                        ) -> Tuple[torch.Tensor]:
    """The backward kernel's float32 workspace for chunks of ``l``: the state gradients
    [B, nc, H, P, N] (each chunk's contribution, then the gradient of the state leaving
    it)."""
    return (torch.empty((bsz, s // l, h, p, n), dtype=torch.float32, device=device),)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32, 10 mantissa bits, to nearest with ties away from zero:
    what ``cvt.rna.tf32.f32`` gives the bf16 backward kernel's tensor-core operands."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_parts(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 intermediate as the bf16 backward kernel feeds it to the tensor cores:
    two TF32 numbers, hi = rna(t) and lo = rna(t - hi)."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, split_a: bool, split_b: bool,
             tf32: bool) -> torch.Tensor:
    """``einsum(eq, a, b)``; with ``tf32`` as the bf16 kernel's tensor cores form it: a
    split operand (a float32 intermediate) as its two TF32 parts, the other exact, the
    lo·lo term dropped."""
    if not tf32 or not (split_a or split_b):
        return torch.einsum(eq, a, b)
    ah, al = tf32_parts(a) if split_a else (a, None)
    bh, bl = tf32_parts(b) if split_b else (b, None)
    out = torch.einsum(eq, ah, bh)
    if al is not None:
        out = out + torch.einsum(eq, al, bh)
    if bl is not None:
        out = out + torch.einsum(eq, ah, bl)
    return out


def chunked_backward_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                               c: torch.Tensor, dy: torch.Tensor, dhf: Optional[torch.Tensor],
                               chunk: int, saved: Optional[Tuple[torch.Tensor, ...]] = None,
                               ws: Optional[Tuple[torch.Tensor, ...]] = None, tf32: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's passes in float32 PyTorch, with its workspace layout:
    ``saved`` is what the forward leaves (its three workspaces filled as
    ``chunked_reference`` fills them, and the final state; None: computed here),
    ``ws`` (as ``backward_workspaces`` makes it) is filled as the kernel fills it.
    With ``tf32`` each product is formed as the bf16 kernel forms it on the tensor
    cores: an operand that is a float32 intermediate as its two TF32 parts
    (``tf32_parts``), x, dy, b and c as they are (bf16 values are exact in TF32).
    (dx in x's dtype, da float32, db and dc in b's dtype).

    The dx pass writes dx_j = Σ_{i>=j} L_ij (C·Bᵀ)_ij dy_i + exp(cum_last -
    cum_j)·G b_j and, with y recomputed, the gradient of cum_i as dy_i·y_i -
    x_i·dx_i, plus <G, H_next> at the chunk's last step (every term of y_i scales with
    exp(cum_i), of dx_j with exp(-cum_j), and the state leaving the chunk with
    exp(cum_last)). The db/dc pass sums over the heads first, V = Σ_h L_h ⊙ dY_h·X_hᵀ,
    then dc = V·B + Σ_h (exp(cum_h) ⊙ dY_h)·H_h and db = Vᵀ·C + Σ_h (exp(cum_last_h -
    cum_h) ⊙ X_h)·G_h: b and c are shared by the heads."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"ssd: S = {s} is not a multiple of chunk = {l}")
    nc = s // l
    mm = lambda eq, u, v, su, sv: _product(eq, u, v, su, sv, tf32)  # noqa: E731
    if saved is None:
        fws = workspaces(bsz, s, h, p, n, l, x.device)
        _, hf = chunked_reference(x, a, b, c, chunk, fws)
        saved = (*fws, hf)
    states, cbt, decay, hf = saved
    (dstates,) = ws if ws is not None else backward_workspaces(bsz, s, h, p, n, l, x.device)
    xc = x.float().reshape(bsz, nc, l, h, p)
    dyc = dy.float().reshape(bsz, nc, l, h, p)
    cum = a.float().reshape(bsz, nc, l, h).cumsum(dim=2)                  # [B, nc, l, H]
    bc, cc = b.float().reshape(bsz, nc, l, n), c.float().reshape(bsz, nc, l, n)
    ecum = torch.exp(cum)
    dec = torch.exp(decay[:, :, None] - cum)                              # [B, nc, l, H]
    # 1. chunk pass: each chunk's contribution Σ_i exp(cum_i)·dy_iᵀc_i
    dstates.copy_(mm("bclhp,bcln->bchpn", dyc * ecum[..., None], cc, True, False))
    # 2. state pass, in reverse: dstates[:, c] <- the gradient of the state leaving chunk c
    grad = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
            if dhf is None else dhf.float())
    for i in reversed(range(nc)):
        contrib = dstates[:, i].clone()
        dstates[:, i] = grad
        grad = grad * torch.exp(decay[:, i])[..., None, None] + contrib
    # 3. chunk pass: dx and da
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()   # [i, j]: j <= i
    cumt = cum.transpose(2, 3)                                            # [B, nc, H, l]
    L = torch.exp(torch.where(tri, cumt[..., :, None] - cumt[..., None, :], NEG_INF))
    w = L * cbt.transpose(2, 3)[:, :, None]                               # [B, nc, H, i, j]
    y = (mm("bchij,bcjhp->bcihp", w, xc, True, False)
         + mm("bcin,bchpn->bcihp", cc, states, False, True) * ecum[..., None])
    dx = (mm("bchij,bcihp->bcjhp", w, dyc, True, False)
          + mm("bcjn,bchpn->bcjhp", bc, dstates, False, True) * dec[..., None])
    nxt = torch.cat([states[:, 1:], hf[:, None]], dim=1)                  # the state leaving c
    dcum = (dyc * y).sum(dim=-1) - (xc * dx).sum(dim=-1)                  # [B, nc, l, H]
    dcum[:, :, -1] += (dstates * nxt).sum(dim=(-1, -2))
    da = dcum.flip(2).cumsum(dim=2).flip(2)
    # 4. chunk pass: db and dc, the heads summed on chip
    v = (L * torch.einsum("bcihp,bcjhp->bchij", dyc, xc)).sum(dim=2)     # [B, nc, i, j]
    dc = (mm("bcij,bcjn->bcin", v, bc, True, False)
          + mm("bcihp,bchpn->bcin", dyc * ecum[..., None], states, True, True))
    db = (mm("bcij,bcin->bcjn", v, cc, True, False)
          + mm("bcjhp,bchpn->bcjn", xc * dec[..., None], dstates, True, True))
    return (dx.reshape(bsz, s, h, p).to(x.dtype), da.reshape(bsz, s, h),
            db.reshape(bsz, s, n).to(b.dtype), dc.reshape(bsz, s, n).to(c.dtype))


def backward_cost(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                  chunk: int, dhf: bool = False) -> _build.Cost:
    """Per (head, chunk): dY·Xᵀ, the diagonal block's dx, and its shares of dc and db on
    the l(l+1)/2 causal pairs (2P, 2P, 2N and 2N operations a pair), and the four
    l·P·N products with the states (Σ exp(cum)·dyᵀc, G·b, Hᵀ·dy, Gᵀ·x). x, dy, b and c
    in x's dtype, a, the final state's gradient (``dhf``) and what the forward kernel
    saved (the states entering each chunk, C·Bᵀ, the chunk decays and the final state)
    in float32 read once; dx, db and dc in x's dtype and da in float32 written once."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    nc = s // l
    flops = bsz * nc * h * (l * (l + 1.0) * (2 * p + 2 * n) + 8.0 * l * p * n)
    nbytes = ((3 * bsz * s * h * p + 4 * bsz * s * n) * x.element_size()
              + (2 * bsz * s * h + bsz * nc * h * (p * n + 1) + bsz * nc * l * l
                 + (1 + dhf) * bsz * h * p * n) * 4)
    return _build.Cost(flops, float(nbytes))


def backward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             dy: torch.Tensor, dhf: Optional[torch.Tensor], states: torch.Tensor,
             cb: torch.Tensor, decay: torch.Tensor, hf: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: the forward's inputs, dy [B, S, H, P] of x's dtype, dhf
    [B, H, P, N] float32 or None (zero), and what the forward kernel left (its
    workspaces ``states``, ``cb``, ``decay`` and the final state ``hf``) ->
    (dx in x's dtype, da float32, db and dc in x's dtype)."""
    global backward_launches
    if x.device.type == "meta":
        return torch.empty_like(x), torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
    extra = {} if dhf is None else {"dhf": dhf}
    l = _check("ssd backward", x, a, b, c, chunk, dy=dy, states=states, cb=cb, decay=decay,
               hf=hf, **extra)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // l
    _build.require(dy.shape == x.shape and dy.dtype == x.dtype, "ssd backward: dy must match x")
    for name, t, shape in (("dhf", dhf, (bsz, h, p, n)), ("hf", hf, (bsz, h, p, n)),
                           ("states", states, (bsz, nc, h, p, n)), ("cb", cb, (bsz, nc, l, l)),
                           ("decay", decay, (bsz, nc, h))):
        _build.require(t is None or (tuple(t.shape) == shape and t.dtype == torch.float32),
                       f"ssd backward: {name} must be float32 {list(shape)}")
    dx, da, db, dc = (torch.empty_like(t) for t in (x, a, b, c))
    ws = backward_workspaces(bsz, s, h, p, n, l, x.device)
    fn = getattr(_build.library("ssd"), _BACKWARD_ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
                    None if dhf is None else dhf.data_ptr(), states.data_ptr(), cb.data_ptr(),
                    decay.data_ptr(), hf.data_ptr(), dx.data_ptr(), da.data_ptr(), db.data_ptr(),
                    dc.data_ptr(), *(t.data_ptr() for t in ws), bsz, s, h, p, n, l,
                    _build.stream(x.device)), "ssd backward")
    backward_launches += 1
    return dx, da, db, dc


class SSDFunction(torch.autograd.Function):
    """``ssd`` (the kernel, which keeps its workspaces for the backward; ``plain`` on the
    CPU) forward, ``backward`` (the kernel; ``plain_backward`` on the CPU) backward.
    The gradient of an unused final state is None, which the backward takes as zero."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = min(chunk, x.shape[1])
        if x.device.type == "cpu":
            ctx.save_for_backward(x, a, b, c)
            return plain(x, a, b, c, ctx.chunk)
        y, hf, ws = forward_with_workspaces(x, a, b, c, ctx.chunk)
        ctx.save_for_backward(x, a, b, c, *ws, hf)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, a, b, c, *saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dhf = None if dhf is None else dhf.float().contiguous()
        cost = lambda: backward_cost(x, a, b, c, chunk=ctx.chunk, dhf=dhf is not None)
        with _build.kernel_scope("ssd_backward", cost):
            if x.device.type == "cpu":
                grads = plain_backward(x, a, b, c, dy, dhf, ctx.chunk)
            else:
                grads = backward(x, a, b, c, dy, dhf, *saved, chunk=ctx.chunk)
        return (*grads, None)
