"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu``, their plain version
and their gradient.

Counterpart of ``repro.kernels.flash_attention``: GQA prefill attention with
an online softmax, causal and sliding-window masks. ``window`` is a runtime
int (<= 0 means full attention). ``flash_attention`` launches a kernel on
CUDA tensors and raises on anything else; ``plain`` (the chunked online
softmax the JAX model runs) is the PyTorch version the CPU path and the
tests use. On ``meta`` tensors ``flash_attention`` returns an empty output of
the kernel's shape (the dry-run); ``cost`` is the work of one call.

The source holds two kernels, and ``kernel_for`` picks one by (dtype,
head_dim): bf16 at head_dim 64 or 128, the shapes of every served model,
runs on the tensor cores (``wgmma``, any GQA group size); float32, and bf16 at
other head dims, run on the CUDA cores (at most ``MAX_GROUP`` query heads per
KV head).

``FlashAttentionFunction`` is the kernel under autograd: its forward is
``forward_with_lse`` (the kernel, which also writes each row's logsumexp;
``plain`` on CPU tensors), its backward is ``backward``, the backward kernels
of the same source (``plain_backward``, the gradient formula in torch ops, on
CPU tensors; the reference has no backward kernel: XLA differentiates its
``chunked_attention``). In bf16 at head_dim 64 and 128 the backward runs on the tensor
cores by one of two routes, which ``one_pass_for`` chooses: the one pass (head_dim 64), over a
persistent grid that sums each query tile's dQ in a fixed order (``backward_plan`` says which
key blocks and query tiles meet, ``backward_schedule`` deals the work items to the grid,
``resident_blocks``, and fixes that order), or a dK/dV kernel and a dQ kernel.
``chunked_backward_reference`` is the one pass in float32 PyTorch, for the tests.
"""
from __future__ import annotations

import heapq
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF, chunked_attention as plain

__all__ = ["flash_attention", "plain", "cost", "allowed_pairs", "kernel_for", "launches", "MAX_GROUP", "MAX_HEAD_DIM",
           "WGMMA_HEAD_DIMS", "forward_with_lse", "plain_lse", "plain_backward",
           "chunked_backward_reference", "first_dead_row", "dead_row_keys", "KEY_BLOCK",
           "QUERY_TILE", "BackwardPlan", "backward_plan", "backward_items", "backward_schedule",
           "resident_blocks", "one_pass_for",
           "backward", "backward_cost", "backward_launches", "FlashAttentionFunction"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)
backward_launches = 0  # backward kernel launches since the last reset

MAX_GROUP = 64      # query heads per KV head of the CUDA-core kernel (simt::kRows)
MAX_HEAD_DIM = 128  # simt::kMaxDh; the tensor-core kernel takes WGMMA_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)

# float32 bytes of one block of P (and of each of its same-sized companions S, dP,
# dS) in the backward: granite-8b's [2, 32, 4096, 4096] would be 4.3 GB in one piece;
# and at most BACKWARD_BLOCK_ROWS query positions a block, so that a causal block's
# masked pairs, which it multiplies all the same, stay a small share at any batch
# (whisper-base's train_4k backward at 2 sequences a rank: 1024-row blocks multiply
# 1.25x the causal pairs, 512-row blocks 1.12x)
BACKWARD_BLOCK_BYTES = 256 << 20
BACKWARD_BLOCK_ROWS = 512

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_WGMMA = "flash_attention_bf16_wgmma"
# each forward entry's backward entry: the same split by (dtype, head_dim)
_BACKWARD_ENTRY = {e: e.replace("flash_attention_", "flash_attention_backward_")
                   for e in (*_ENTRY.values(), _WGMMA)}


def kernel_for(dtype: torch.dtype, dh: int) -> str:
    """The C entry for q's dtype and head_dim: the tensor-core kernel for bf16 at
    ``WGMMA_HEAD_DIMS``, else the CUDA-core kernel of the dtype."""
    return _WGMMA if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS else _ENTRY[dtype]


def allowed_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) position pairs the masks allow: key j <= query i when causal, and
    i - j < window when ``window`` > 0, positions from 0 as in ``plain``."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
         window: int = 0) -> _build.Cost:
    """QKᵀ and PV on the allowed pairs (4·dh operations a pair and query head); q, k,
    v and the output read or written once."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    flops = 4.0 * b * hq * dh * allowed_pairs(sq, sk, causal, window)
    return _build.Cost(flops, float((2 * sq * hq + 2 * sk * hkv) * b * dh * q.element_size()))


def _check_forward(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Refuse what the kernels do not take; the C entry for q's dtype and head_dim."""
    _build.check_inputs(what, q.device, q=q, k=k, v=v)
    _build.require(q.dtype in _ENTRY, f"{what}: dtype {q.dtype} not supported")
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype, f"{what}: k and v must have q's dtype")
    _build.require(q.dim() == 4 and k.dim() == 4, f"{what}: q [B,Sq,Hq,dh], k/v [B,Sk,Hkv,dh]")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _build.require(tuple(k.shape) == (b, sk, hkv, dh) and v.shape == k.shape,
                   f"{what}: k/v shapes disagree with q")
    _build.require(hkv > 0 and hq % hkv == 0, f"{what}: needs Hq % Hkv == 0")
    entry = kernel_for(q.dtype, dh)
    if entry == _WGMMA:
        _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                       f"{what}: q, k and v must be 16-byte aligned")
    else:
        _build.require(hq // hkv <= MAX_GROUP and 0 < dh <= MAX_HEAD_DIM,
                       f"{what}: needs Hq/Hkv <= {MAX_GROUP} and head_dim <= {MAX_HEAD_DIM}")
    return entry


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
             scale: Optional[float], lse: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    entry = _check_forward("flash_attention", q, k, v)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else dh**-0.5)
    out = torch.empty_like(q)
    # rows that allow no key take V's mean over dead_row_keys(Sk) columns, as in ``plain``
    dead = (torch.empty((b, hkv, dh), dtype=torch.float32, device=q.device)
            if first_dead_row(sq, sk, window) < sq else None)
    fn = getattr(_build.library("flash_attention"), entry)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    None if dead is None else dead.data_ptr(), b, sq, sk, hq, hkv, dh, scale,
                    int(bool(causal)), int(window), dead_row_keys(sk) if dead is not None and sk else 0,
                    _build.stream(q.device)),
                 "flash_attention")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, Hq, dh]; k, v [B, Sk, Hkv, dh] of q's dtype -> [B, Sq, Hq, dh]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    return _forward(q, k, v, causal, window, scale, None)


def forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                     window: int = 0, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s launch that also writes each row's logsumexp of its scaled
    scores: (out, lse float32 [B, Hq, Sq], natural units, -inf on a row that allows no
    key), what the backward kernels read."""
    b, sq, hq, _ = q.shape
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return torch.empty_like(q), lse
    return _forward(q, k, v, causal, window, scale, lse), lse


def plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   do: torch.Tensor, *, causal: bool = True, window: int = 0,
                   scale: Optional[float] = None, kv_block: int = 512
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``plain(q, k, v, causal=, window=, scale=, kv_block=)`` = ``o`` for
    the output gradient ``do``: (dq, dk, dv) in q's dtype.

    P is recomputed in float32 under the mask of ``chunked_attention``: key
    position <= query position if causal, their distance < window if window > 0;
    positions count from 0 for Sq != Sk too. Then dV = Pᵀ·dO, D = rowsum(dO ∘ O),
    dS = P ∘ (dO·Vᵀ − D), dQ = scale·dS·K, dK = scale·dSᵀ·Q. A KV head's G query
    heads are stacked as rows of one product, so their gradients sum into it. The
    products run in the input dtype and sum into float32, and the values round to
    it where the reference's differentiated ``chunked_attention`` rounds them:
    Q·Kᵀ before the scale, P before dV, scale·dS before dQ and dK. Query rows go
    in blocks of at most ``BACKWARD_BLOCK_ROWS`` positions whose float32 P holds at
    most ``BACKWARD_BLOCK_BYTES``; a block reads only the keys its mask can allow.
    A query row that allows no key (``first_dead_row``: one at or past Sk + window - 1,
    which needs a window and Sq > Sk) is, as in the reference, the mean of V over every
    key and the zero columns that pad Sk to the KV block (``dead_row_keys``): it passes
    dO/``dead_row_keys`` to each key's dV, summed over the G heads in float32 before dV
    rounds, and nothing to dQ and dK.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else dh**-0.5)
    dt, dev = q.dtype, q.device
    bh = b * hkv
    # [B·Hkv, S, G, dh]: a block of positions is a contiguous run of (position, head) rows
    rows_of = lambda t: t.reshape(b, sq, hkv, g, dh).transpose(1, 2).reshape(bh, sq, g, dh)
    qh, doh = rows_of(q), rows_of(do.contiguous())
    kh, vh = (t.transpose(1, 2).reshape(bh, sk, dh) for t in (k, v))
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b, sq, hkv, g).transpose(1, 2)
    delta = delta.reshape(bh, sq * g, 1)
    dq = torch.zeros((bh, sq, g, dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((bh, sk, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros((bh, sk, dh), dtype=torch.float32, device=dev)
    live_rows = first_dead_row(sq, sk, window)
    rows = max(1, min(BACKWARD_BLOCK_ROWS, BACKWARD_BLOCK_BYTES // (4 * b * hq * max(sk, 1))))
    scale_f32 = torch.full((1,), scale, dtype=torch.float32, device=dev)
    for q0 in range(0, live_rows, rows):
        q1 = min(live_rows, q0 + rows)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        k1 = min(sk, q1) if causal else sk
        r = (q1 - q0) * g
        qb, dob = qh[:, q0:q1].reshape(bh, r, dh), doh[:, q0:q1].reshape(bh, r, dh)
        kb, vb = kh[:, k0:k1], vh[:, k0:k1]                    # [B·Hkv, k1 - k0, dh]
        s = torch.bmm(qb, kb.transpose(1, 2))                  # [B·Hkv, r, k1 - k0]
        qpos = torch.arange(q0, q1, device=dev).repeat_interleave(g)[:, None]
        kpos = torch.arange(k0, k1, device=dev)[None, :]
        allowed = None
        if causal:
            allowed = kpos <= qpos
        if window > 0:
            near = qpos - kpos < window
            allowed = near if allowed is None else allowed & near
        if allowed is not None:
            s.masked_fill_(~allowed, NEG_INF)
        p = torch.softmax(s * scale_f32, dim=-1)   # a [1] float32 factor: the product is float32
        del s
        pt = p.to(dt)
        dv[:, k0:k1] += torch.bmm(pt.transpose(1, 2), dob)
        del pt
        # scale·dS = scale·P ∘ (dP − D); P is 0 where the mask refuses, so dS is too
        ds = torch.sub(torch.bmm(dob, vb.transpose(1, 2)), delta[:, q0 * g:q1 * g])
        ds = ds.mul_(p).mul_(scale).to(dt)
        del p
        dq[:, q0:q1] = torch.bmm(ds, kb).reshape(bh, q1 - q0, g, dh)
        dk[:, k0:k1] += torch.bmm(ds.transpose(1, 2), qb)
    if live_rows < sq:
        dv += doh[:, live_rows:].float().sum(dim=(1, 2))[:, None] / dead_row_keys(sk, kv_block)
    dq = dq.reshape(b, hkv, sq, g, dh).transpose(1, 2).reshape(b, sq, hq, dh)
    out = lambda t: t.to(dt).contiguous()
    return out(dq), out(dk.reshape(b, hkv, sk, dh).transpose(1, 2)), \
        out(dv.reshape(b, hkv, sk, dh).transpose(1, 2))


def first_dead_row(sq: int, sk: int, window: int) -> int:
    """The first query position whose mask allows no key (``sq`` if there is none): one at or
    past Sk + window - 1 has every key out of its window, which needs a window and Sq > Sk."""
    return min(sq, sk + window - 1) if window > 0 else sq


def dead_row_keys(sk: int, kv_block: int = 512) -> int:
    """The columns a row that allows no key averages V over in ``plain`` (and the reference's
    ``chunked_attention``) with this KV block: Sk padded with zero columns to a multiple of
    min(kv_block, Sk). Every column of such a row is masked alike, so each weighs the same."""
    blk = min(kv_block, sk)
    return -(-sk // blk) * blk


def _allowed(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """[Sq, Sk] bool: the (query, key) position pairs the masks allow (``allowed_pairs``)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    return ok


def plain_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int = 0,
              scale: Optional[float] = None, rows: int = 512) -> torch.Tensor:
    """Each query row's logsumexp of its allowed scaled scores in float32, what
    ``forward_with_lse`` writes: [B, Hq, Sq], -inf on a row that allows no key. Query
    rows go ``rows`` positions at a time."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else dh**-0.5)
    qf = q.float().reshape(b, sq, hkv, g, dh)
    kf = k.float()
    ok = _allowed(sq, sk, causal, window, q.device)
    out = []
    for q0 in range(0, sq, rows):
        q1 = min(sq, q0 + rows)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:q1], kf) * scale
        out.append(torch.logsumexp(s.masked_fill(~ok[q0:q1], float("-inf")), dim=-1))
    return torch.cat(out, dim=-1).reshape(b, hq, sq)


# the bf16 backward kernel's tiles: a work item is KEY_BLOCK keys of one KV head and batch
# row (one consumer warpgroup a 64-key half), its steps QUERY_TILE query positions of one
# query head each
KEY_BLOCK, QUERY_TILE = 128, 64


class BackwardPlan(NamedTuple):
    """Which tiles of a backward call meet: ``reach[m]`` is the half-open range of query tiles
    that key block m's mask reaches, ``writers[t]`` the inclusive range of key blocks that
    reach query tile t (empty, lo > hi, for a tile of rows that allow no key). Query tile t
    takes its dQ partials from key blocks ``writers[t][1]`` down to ``writers[t][0]``."""
    reach: List[Tuple[int, int]]
    writers: List[Tuple[int, int]]


def backward_plan(sq: int, sk: int, causal: bool, window: int) -> BackwardPlan:
    """The (key block, query tile) pairs that hold an allowed (query, key) pair (as
    ``allowed_pairs`` counts them): key block m's keys [kf, kl] and tile t's rows [qf, ql]
    meet if kf <= ql when causal and kl > qf - window when ``window`` > 0. Both are bands,
    so each key block reaches a run of tiles and each tile a run of key blocks."""
    nkb, nqt = -(-sk // KEY_BLOCK), -(-sq // QUERY_TILE)
    kf = np.arange(nkb) * KEY_BLOCK
    kl = np.minimum(sk, kf + KEY_BLOCK) - 1
    qf = np.arange(nqt) * QUERY_TILE
    ql = np.minimum(sq, qf + QUERY_TILE) - 1
    meet = np.ones((nkb, nqt), dtype=bool)
    if causal:
        meet &= kf[:, None] <= ql[None, :]
    if window > 0:
        meet &= kl[:, None] > qf[None, :] - window

    def run(row):
        hit = np.flatnonzero(row)
        return (int(hit[0]), int(hit[-1]) + 1) if hit.size else (0, 0)

    reach = [run(meet[m]) for m in range(nkb)]
    writers = [(lo, hi - 1) if hi > lo else (1, 0) for lo, hi in (run(meet[:, t]) for t in range(nqt))]
    return BackwardPlan(reach, writers)


def backward_items(b: int, hkv: int, plan: BackwardPlan) -> List[int]:
    """The work items in the order the kernel's blocks take them: every (batch, KV head)'s
    last key block, then every one's last but one, and so on. A key block adds its dQ
    partial to a query tile after the key blocks above it, which come earlier here, so an
    item waits only on earlier items. An item is (b·Hkv + kv head)·n_key_blocks + key block."""
    nkb = len(plan.reach)
    return [grp * nkb + m for m in reversed(range(nkb)) for grp in range(b * hkv)]


def backward_schedule(b: int, sq: int, sk: int, hq: int, hkv: int, causal: bool, window: int,
                      blocks: int) -> np.ndarray:
    """The bf16 backward kernel's work list for a grid of ``blocks`` co-resident blocks, as
    the int32 array it reads:

    - a header [blocks, L, n_key_blocks, n_query_tiles];
    - each key block's reach (``backward_plan``: first tiles, then ends);
    - one row of L + 1 a block: its item count, then its items (``backward_items``);
    - for each item, in item order, where its turns start in the last part;
    - the turns: for each item, for each tile of its reach, how many key blocks add their
      dQ partial to that tile before it (the tile's last writer has turn writers - 1).

    ``backward_items`` are dealt out in their order, each to the block with the least work
    so far (a step, one query tile of one head, a unit; an item one more for its K/V load
    and epilogue). A block takes its items in the list's order, and a tile takes its
    partials in the list's order too, so every item waits only on items taken earlier, by
    blocks that are all resident: the grid cannot deadlock."""
    plan = backward_plan(sq, sk, causal, window)
    g = hq // hkv
    nkb, nqt = len(plan.reach), len(plan.writers)
    order = backward_items(b, hkv, plan)
    rows: List[List[int]] = [[] for _ in range(blocks)]
    load = [(0, j) for j in range(blocks)]
    for item in order:
        lo, hi = plan.reach[item % nkb]
        work, j = heapq.heappop(load)
        rows[j].append(item)
        heapq.heappush(load, (work + (hi - lo) * g + 1, j))
    width = max(len(r) for r in rows)
    table = np.zeros((blocks, width + 1), dtype=np.int64)
    for j, r in enumerate(rows):
        table[j, 0] = len(r)
        table[j, 1:len(r) + 1] = r
    # turn of (item, tile): the tile's writers of its group that come earlier in the list
    taken: dict = {}
    turn = {}
    for item in order:
        grp, m = divmod(item, nkb)
        for t in range(*plan.reach[m]):
            turn[item, t] = taken.get((grp, t), 0)
            taken[grp, t] = turn[item, t] + 1
    offsets, turns = [], []
    for item in range(len(order)):
        offsets.append(len(turns))
        turns += [turn[item, t] for t in range(*plan.reach[item % nkb])]
    reach = np.asarray(plan.reach).reshape(-1, 2)
    return np.concatenate([[blocks, width, nkb, nqt], reach[:, 0], reach[:, 1], table.ravel(),
                           offsets, turns]).astype(np.int32)


def chunked_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward kernel's pass in float32 PyTorch: (dq, dk, dv) in q's dtype.

    D = rowsum(dO ∘ O). Each ``KEY_BLOCK``-key block walks the query tiles its mask
    reaches (``backward_plan``), and for each the G query heads in turn: from
    P = exp(scale·QKᵀ − lse) it adds to its dV and dK and hands the tile its dQ partial
    dS·K. A query tile sums its partials in the kernel's fixed order, from the highest key
    block down. A row that allows no key adds dO/``dead_row_keys`` to every key's dV (summed
    over the G heads and such rows, in float32 before dV rounds). P and scale·dS round to q's dtype
    before their products, as the kernel rounds them; everything else is float32."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else dh**-0.5)
    dt = q.dtype
    rnd = (lambda t: t) if dt == torch.float32 else (lambda t: t.to(dt).float())
    heads = lambda t: t.float().reshape(b, t.shape[1], hkv, g, dh).permute(0, 2, 3, 1, 4)
    qh, doh = heads(q), heads(do)                                   # [B, Hkv, G, Sq, dh]
    kh, vh = (t.float().transpose(1, 2) for t in (k, v))            # [B, Hkv, Sk, dh]
    delta = (do.float() * o.float()).sum(-1).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    lse = lse.reshape(b, hkv, g, sq)
    ok = _allowed(sq, sk, causal, window, q.device)
    plan = backward_plan(sq, sk, causal, window)
    dk = torch.zeros((b, hkv, sk, dh), device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.zeros_like(qh)
    for m in reversed(range(len(plan.reach))):      # each tile's dQ order: key blocks downwards
        k0, k1 = m * KEY_BLOCK, min(sk, (m + 1) * KEY_BLOCK)
        kb, vb = kh[:, :, k0:k1], vh[:, :, k0:k1]
        for t in range(*plan.reach[m]):
            q0, q1 = t * QUERY_TILE, min(sq, (t + 1) * QUERY_TILE)
            for gi in range(g):
                qb, dob = qh[:, :, gi, q0:q1], doh[:, :, gi, q0:q1]
                s = kb @ qb.transpose(-1, -2)                       # Sᵀ [B, Hkv, keys, queries]
                p = torch.where(ok[q0:q1, k0:k1].T, torch.exp(s * scale - lse[:, :, gi, None, q0:q1]),
                                torch.zeros((), device=s.device))
                ds = rnd(p * (vb @ dob.transpose(-1, -2) - delta[:, :, gi, None, q0:q1]) * scale)
                dv[:, :, k0:k1] += rnd(p) @ dob
                dk[:, :, k0:k1] += ds @ qb
                dq[:, :, gi, q0:q1] += ds.transpose(-1, -2) @ kb
    dead = first_dead_row(sq, sk, window)
    if dead < sq:
        dv += doh[:, :, :, dead:].sum(dim=(2, 3))[:, :, None] / dead_row_keys(sk)
    out = lambda t: t.to(dt).contiguous()
    return (out(dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)), out(dk.transpose(1, 2)),
            out(dv.transpose(1, 2)))


def backward_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int = 0) -> _build.Cost:
    """dV, dP, dQ and dK on the allowed pairs (8·dh operations a pair and query head; the
    recompute of P is the kernels' choice, not the gradient's work); q, k, v, o, dO and
    the float32 lse read once, dq, dk and dv written once."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    flops = 8.0 * b * hq * dh * allowed_pairs(sq, sk, causal, window)
    return _build.Cost(flops, float((4 * sq * hq + 4 * sk * hkv) * b * dh * q.element_size()
                                    + 4 * b * hq * sq))


def one_pass_for(dtype: torch.dtype, dh: int, causal: bool, window: int) -> bool:
    """Whether the bf16 tensor-core backward takes the one pass (else the two kernels): at
    head_dim 64 under a causal sliding window, the shapes where it measured faster (hymba's
    sliding layers; ``PERF.md``: the two kernels won at its global layers and whisper's self
    and cross attention, and the one pass does not run at 128). Both routes hold the same
    gradient; this is the one place that chooses."""
    return dtype == torch.bfloat16 and dh == 64 and causal and window > 0


_resident: dict = {}    # (device index, head_dim) -> co-resident blocks of the one-pass kernel
_schedules: dict = {}   # the work lists already on a device, by shape


def resident_blocks(device: torch.device, dh: int) -> int:
    """How many blocks of the bf16 backward kernel at head_dim ``dh`` the card holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times its SMs): its grid."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), dh)
    if key not in _resident:
        n = _build.library("flash_attention").flash_attention_backward_resident_blocks(dh)
        _build.check(0 if n > 0 else (-n or 1), "flash_attention backward: resident blocks")
        _resident[key] = n
    return _resident[key]


def _schedule_on(device: torch.device, b: int, sq: int, sk: int, hq: int, hkv: int,
                 causal: bool, window: int, dh: int) -> Tuple[torch.Tensor, int]:
    """``backward_schedule`` for the card's resident grid (no larger than the items), as an
    int32 tensor on ``device``, made once a shape."""
    blocks = min(b * hkv * -(-sk // KEY_BLOCK), resident_blocks(device, dh))
    key = (str(device), b, sq, sk, hq, hkv, bool(causal), int(window), blocks)
    if key not in _schedules:
        _schedules[key] = torch.from_numpy(backward_schedule(b, sq, sk, hq, hkv, bool(causal),
                                                             int(window), blocks)).to(device)
    return _schedules[key], blocks


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True, window: int = 0,
             scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: q, k, v, the forward's o and lse (``forward_with_lse``) and
    dO of o's shape -> (dq, dk, dv) in q's dtype; the bf16 tensor-core route is
    ``one_pass_for``'s."""
    return _backward(q, k, v, o, lse, do, causal, window, scale,
                     one_pass_for(q.dtype, q.shape[-1], causal, window))


def _backward(q, k, v, o, lse, do, causal: bool, window: int, scale: Optional[float],
              one_pass: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``backward`` by the given bf16 tensor-core route (``chip_smoke.py`` times both)."""
    global backward_launches
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    what = "flash_attention backward"
    entry = _check_forward(what, q, k, v)
    _build.check_inputs(what, q.device, o=o, lse=lse, do=do)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _build.require(o.shape == q.shape and do.shape == q.shape and o.dtype == q.dtype
                   and do.dtype == q.dtype, f"{what}: o and dO must have q's shape and dtype")
    _build.require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, hq, sq),
                   f"{what}: lse must be float32 [B, Hq, Sq]")
    if entry == _WGMMA:
        _build.require(o.data_ptr() % 16 == 0 and do.data_ptr() % 16 == 0,
                       f"{what}: o and dO must be 16-byte aligned")
    scale = float(scale if scale is not None else dh**-0.5)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    sched = acc = flags = None
    blocks = 0
    _build.require(not one_pass or (entry == _WGMMA and dh == 64),
                   f"{what}: the one pass takes bf16 at head_dim 64")
    sqp = -(-sq // QUERY_TILE) * QUERY_TILE
    if one_pass:   # the work list and the ordered dQ sums
        sched, blocks = _schedule_on(q.device, b, sq, sk, hq, hkv, causal, window, dh)
        acc = torch.empty((b, hq, sqp, dh), **f32)   # each query tile's ordered dQ sum
        flags = torch.empty((b, hq, sqp // QUERY_TILE), dtype=torch.int32, device=q.device)
    if entry == _WGMMA:   # the base-2 lse and D, rows padded to the query tile
        ws = torch.empty((2, b, hq, sqp), **f32)
    else:
        ws = torch.empty((b, hq, sq), **f32)
    dead = torch.empty((b, hkv, dh), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = getattr(_build.library("flash_attention"), _BACKWARD_ENTRY[entry])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                    ptr(acc), ptr(flags), dead.data_ptr(), ptr(sched), b, sq, sk, hq, hkv, dh,
                    scale, int(bool(causal)), int(window), dead_row_keys(sk), blocks,
                    _build.stream(q.device)), what)
    backward_launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``forward_with_lse`` (the kernel; ``plain`` on the CPU) forward, ``backward`` (the
    kernels; ``plain_backward`` on the CPU) backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.mask = (causal, window, scale)
        if q.device.type == "cpu":
            o = plain(q, k, v, causal=causal, window=window, scale=scale)
            ctx.save_for_backward(q, k, v, o)
            return o
        o, lse = forward_with_lse(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        do = do.contiguous()
        cost = lambda: backward_cost(q, k, v, causal=causal, window=window)
        with _build.kernel_scope("flash_attention_backward", cost):
            if q.device.type == "cpu":
                grads = plain_backward(q, k, v, o, do, causal=causal, window=window, scale=scale)
            else:
                grads = backward(q, k, v, o, lse[0], do, causal=causal, window=window, scale=scale)
        return (*grads, None, None, None)
