#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each of which raises on failure (the script then exits non-zero):

  0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  1. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a;
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the main paths' shapes (granite-8b's, olmoe-1b-7b's, mamba2-130m's,
     hymba-1.5b's, glm4-9b's G = 16, qwen2.5-32b's G = 5 at 40 query heads,
     deepseek's and internvl2's G = 8 at 64, and whisper-base's non-causal
     encoder and cross-attention, causal decoder self-attention, partly filled
     self cache and all-valid cross cache), in bf16 and f32, with kernel, plain and library device
     times (``Timer``) and the card's bound for the same work;
  3. serving, once per model: granite-8b, glm4-9b, qwen2.5-32b, deepseek-67b
     (dense; deepseek cut to 44 of 95 layers), olmoe-1b-7b (MoE), mamba2-130m
     (SSM), hymba-1.5b (hybrid, cache 2048 so that its sliding layers hold a
     ring of 1024), internvl2-76b (vlm, cut to 35 of 80 layers, 256 patches a
     request) and whisper-base (encdec, cache 448, 1500 frames a request) at
     full width in bf16, random weights from a seeded generator, 8 requests
     through ``ContinuousBatcher`` (4 slots); launch counters, set to 0 just
     before each run and read just after, must equal the expected counts;
     then a profile of one prefill and a few decode steps by kernel group
     (and, for olmoe, the MoE layer's device time);
  4. the models against the plain CPU reference, each at full width cut to
     2 layers (whisper-base whole): a prefill plus 4 decode steps, on the
     card through the kernels and on the CPU through the plain versions
     (granite, glm4, qwen2.5 with non-zero QKV biases, olmoe, mamba2,
     internvl2 with its patches and whisper with its frames on a 128-token
     prompt, hymba on a 1300-token prompt in a 2048 cache with layer 1
     sliding; the logits, for olmoe also the share of tokens routed to
     another set of experts, for mamba2 and hymba also the final SSM state);
     and a float32 granite (float32 queries against its bf16 cache) and a
     float32 whisper-base (one request decoding past its 448-slot cache)
     served through the batcher on the card, with the CPU batcher's tokens.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Nothing of the JAX package is imported.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense), at its 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 3e-2, "float32": 2e-3}    # tests/test_kernels.py::_tol
SERVE_SLOTS, SERVE_CACHE, SERVE_REQUESTS, SERVE_NEW = 4, 1024, 8, 32
SERVE_ARCHS = ("granite-8b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b", "glm4-9b", "qwen2.5-32b",
               "deepseek-67b", "internvl2-76b", "whisper-base")
# deepseek-67b (134.9 GB of bf16 weights, the reference's num_params) and internvl2-76b
# (141.2 GB) do not fit the card's 80 GB at full depth: each is served at the deepest
# cut whose weights are no larger than those of qwen2.5-32b at full depth (65.5 GB),
# which the card serves with its cache and activations (``serve_depth``: 44 and 35
# layers); widths are never cut
DEPTH_CUT_ARCHS, WEIGHT_BUDGET_ARCH = ("deepseek-67b", "internvl2-76b"), "qwen2.5-32b"
WHISPER_CACHE = 448   # Whisper's text context
# phase 4: every model but deepseek-67b (the same dense code as glm4 and qwen2.5)
REFERENCE_ARCHS = ("granite-8b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b", "glm4-9b",
                   "qwen2.5-32b", "internvl2-76b", "whisper-base")
# hymba serves a 2048 cache, so its sliding layers (window 1024) hold a ring; its
# prompts straddle the window: the prefill's window mask bites over 1024, the
# trailing-window rule under it, and the decode ring wraps
HYMBA_CACHE = 2048
HYMBA_PROMPT_LENS = (96, 700, 1020, 1100, 1500, 2000, 300, 1800)
# rmsnorm launches per layer: the block norms, plus the gated norm of an SSM mixer,
# plus the hybrid's two branch output norms
NORMS_PER_LAYER = {"dense": 2, "moe": 2, "ssm": 2, "hybrid": 5, "vlm": 2}
# phase 4: the share of (token, layer) top-k expert sets that a bf16 run on the
# card may route differently from the float32 CPU run (bf16 rounding moves
# near-ties between the k-th and the next expert); float32 must route alike
MAX_ROUTE_DIFF = {"bfloat16": 0.25, "float32": 0.0}
# phase 4: the final SSM state, card against CPU (tests/test_kernels.py::_tol in float32;
# in bf16 every activation of the stack is rounded, as for the logits' 5e-2)
STATE_TOL = {"bfloat16": 5e-2, "float32": 2e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
class Timer:
    """Mean device time per call of a function, without the host's launch overhead.

    A sleep kernel holds the device while the host enqueues ``iters`` calls
    between two CUDA events, so the events see the calls back to back. The
    calls rotate over sets of inputs: ``copies(nbytes)`` sets, enough that
    together they move twice the 50 MB L2, so each call finds its inputs
    cold. Past ``MAX_COPIES`` sets a shape stays small enough to stay in the
    L2 (under ``L2_BYTES / MAX_COPIES`` a call: the decode rmsnorm, the
    ragged test shapes); its time is then flagged ``L2-warm``. If the host
    takes longer to enqueue than the sleep lasts, the time is flagged
    ``host-bound`` (it then includes host gaps).
    """

    L2_BYTES = 50e6
    MIN_COPIES, MAX_COPIES = 4, 16
    SLEEP_CYCLES = 200_000_000

    def __init__(self, torch):
        self.torch = torch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(self.SLEEP_CYCLES)
        end.record()
        torch.cuda.synchronize()
        self.sleep_ms = start.elapsed_time(end)

    @classmethod
    def copies(cls, nbytes: float) -> int:
        """Input sets to rotate over for a call that moves ``nbytes``."""
        return min(cls.MAX_COPIES, max(cls.MIN_COPIES, math.ceil(2 * cls.L2_BYTES / nbytes)))

    def ms(self, fns, iters: int = 24):
        """(ms per call, host_bound) for calls cycling over ``fns``."""
        torch = self.torch
        for fn in fns:  # warm-up
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(self.SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fns[i % len(fns)]()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters, host_ms > self.sleep_ms


def bound_ms(nbytes: float, flops: float, op_type: str):
    """Least time for the work: bytes over peak bandwidth or operations over the peak
    rate of their type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_card(torch) -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])  # name, power limit: as nvidia-smi prints them
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    name = smi.splitlines()[0]
    variant = "the SXM part" if "HBM3" in name else "the SXM part, NOT this variant: bounds too low"
    log(f"[card] bounds use {variant}'s peaks: {PEAK_BYTES_PER_S / 1e12} TB/s, "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16, {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def _no_tf32(torch):
    """The MoE router product must be full float32, or tokens go to other experts."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on: the router needs float32")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    records = _build.build_all(verbose=True)
    for r in records.values():
        how = "cache hit" if r.cached else f"nvcc {r.seconds:.2f} s"
        log(f"[build] {r.name}: {how} -> {r.path.name}")
    log(f"[build] total {time.perf_counter() - t0:.2f} s")


def _check(name, got, want, dtype_name, tol=None):
    err = (got.float() - want.float()).abs().max().item()
    tol = tol or TOL[dtype_name]
    ok = bool(((got.float() - want.float()).abs() <= tol + tol * want.float().abs()).all())
    log(f"[kernels] {name}: max_abs_err {err:.3e} (tolerance rtol=atol={tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def phase_kernels(torch, timer: Timer):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import ssd as kssd
    from repro_torch.models.transformer import _sliding_ring

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    # the yardsticks: F.rms_norm (torch >= 2.4), SDPA with enable_gqa (torch >= 2.5)
    has_gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dt)

    def record(entry, main: bool, name, case, make, nbytes, flops, dtype_name, op_type,
               label=None, tol=None):
        """``make()`` draws fresh inputs and returns (kernel, plain, library or None) on them;
        ``dtype_name`` is the output's dtype (it sets the tolerance unless ``tol`` does),
        ``op_type`` the arithmetic's (it sets the peak rate of the bound)."""
        label = label or dtype_name
        sets = [make() for _ in range(Timer.copies(nbytes))]
        kernel_fn, plain_fn, lib_fn = sets[0]
        out, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if isinstance(out, tuple):   # several outputs (ssd: y and the final state), held together
            out, want = (torch.cat([t.float().flatten() for t in ts]) for ts in (out, want))
        err = _check(f"{name} {case} {label}", out, want, dtype_name, tol)
        (k_ms, k_hb), (p_ms, p_hb) = (timer.ms([st[i] for st in sets]) for i in (0, 1))
        l_ms, l_hb = timer.ms([st[2] for st in sets]) if lib_fn is not None else (None, False)
        b_ms, b_by = bound_ms(nbytes, flops, op_type)
        warm = len(sets) * nbytes < Timer.L2_BYTES
        flag = lambda hb: " (host-bound)" * hb + " (L2-warm)" * warm
        log(f"[kernels] {name} {case} {label}: kernel_ms {k_ms:.5f}{flag(k_hb)} "
            f"plain_ms {p_ms:.5f}{flag(p_hb)} "
            f"library_ms {('%.5f' % l_ms) + flag(l_hb) if l_ms is not None else 'null'} "
            f"bound_ms {b_ms:.5f} = {1e3 * b_ms:.2f} us ({b_by}: {nbytes / 1e6:.3f} MB, "
            f"{flops / 1e9:.4f} GFLOP); share of bound {b_ms / k_ms:.4f}"
            f"{'' if l_ms is None else f', kernel/library {k_ms / l_ms:.2f}x'}")
        if main:
            entry.update(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=l_ms)

    # --- rmsnorm: prefill [1, 1024, 4096] and decode [4, 4096] ---
    e_rms = dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
                 replaces="src/repro/kernels/rmsnorm.py:25")
    lib_rms = getattr(F, "rms_norm", None)
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for shape in ((1, 1024, 4096), (4, 4096)):
            def make(shape=shape, dt=dt):
                x, s = rnd(shape, dt), rnd(shape[-1:], dt)
                return (lambda: krms.rmsnorm(x, s, 1e-5), lambda: krms.plain(x, s, 1e-5),
                        (lambda: lib_rms(x, (shape[-1],), s, 1e-5)) if lib_rms else None)

            numel, size = int(np.prod(shape)), torch.tensor([], dtype=dt).element_size()
            record(e_rms, dtn == "bfloat16" and shape == (1, 1024, 4096), "rmsnorm", str(shape),
                   make, (2 * numel + shape[-1]) * size, 4.0 * numel, dtn,
                   "float32")  # the statistics are float32 arithmetic
    rows.append(e_rms)

    # --- flash attention: granite prefill (G = 4), a ragged Sq, a window; olmoe (G = 1) ---
    e_fl = dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:105")
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for hq, hkv, sq, window in ((32, 8, 1024, 0), (32, 8, 1000, 0), (32, 8, 1024, 256),
                                    (16, 16, 1024, 0)):
            qp, kp = torch.arange(sq, device="cuda")[:, None], torch.arange(sq, device="cuda")[None]
            allowed = (kp <= qp) & ((qp - kp < window) if window > 0 else True)

            def make(sq=sq, window=window, dt=dt, allowed=allowed, hq=hq, hkv=hkv):
                q, k, v = rnd((1, sq, hq, 128), dt), rnd((1, sq, hkv, 128), dt), rnd((1, sq, hkv, 128), dt)

                def lib():
                    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                    if window > 0:
                        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                              enable_gqa=True)
                    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

                return (lambda: kfl.flash_attention(q, k, v, causal=True, window=window),
                        lambda: kfl.plain(q, k, v, causal=True, window=window),
                        lib if has_gqa else None)

            size = torch.tensor([], dtype=dt).element_size()
            nbytes = (2 * sq * hq * 128 + 2 * sq * hkv * 128) * size  # q and out, k and v
            flops = 4.0 * hq * 128 * int(allowed.sum())              # QK^T and PV on allowed pairs
            record(e_fl, dtn == "bfloat16" and hq == 32 and sq == 1024 and window == 0,
                   "flash_attention", f"q[1,{sq},{hq},128] kv[1,{sq},{hkv},128] causal window={window}",
                   make, nbytes, flops, dtn, dtn)
    rows.append(e_fl)

    # --- decode attention: B 4, S 1024, partly filled slots (-1 empty); granite (G = 4),
    # olmoe (G = 1), and a float32 q against the bf16 cache (a float32 model's batcher) ---
    e_dec = dict(name="decode_attention", route="cuda",
                 source="src/repro_torch/csrc/decode_attention.cu",
                 replaces="src/repro/kernels/decode_attention.py:85")
    s = 1024
    fill = torch.tensor([1024, 700, 300, 64], device="cuda", dtype=torch.int32)
    ar = torch.arange(s, device="cuda", dtype=torch.int32)[None]
    slot = torch.where(ar < fill[:, None], ar, -1).to(torch.int32).contiguous()
    slot[1, 5:9] = -1  # holes inside a filled range
    cur = (fill - 1).to(torch.int32)
    slot_none = slot.clone()
    slot_none[3] = -1  # row 3 has no valid slot: the plain version's mean of V over all S
    bf, f32 = torch.bfloat16, torch.float32
    for qdt, cdt, hq, hkv, window, slot_, cur_, what in (
            (bf, bf, 32, 8, 0, slot, cur, ""), (bf, bf, 32, 8, 128, slot, cur, ""),
            (bf, bf, 16, 16, 0, slot, cur, ""), (f32, f32, 32, 8, 0, slot, cur, ""),
            (f32, f32, 32, 8, 128, slot, cur, ""), (f32, f32, 16, 16, 0, slot, cur, ""),
            (f32, bf, 32, 8, 0, slot, cur, ""),
            (bf, bf, 32, 8, 0, slot_none, cur, " row 3 without a valid slot"),
            # batch 1, as a serverless request decodes alone: split_plan matters most here
            (bf, bf, 32, 8, 0, slot[:1].contiguous(), cur[:1].contiguous(), " batch 1")):
        b = slot_.shape[0]
        cdtn = str(cdt).removeprefix("torch.")
        valid = (slot_ >= 0) & (slot_ <= cur_[:, None])
        if window > 0:
            valid &= cur_[:, None] - slot_ < window

        def make(window=window, qdt=qdt, cdt=cdt, valid=valid, hq=hq, hkv=hkv, b=b, slot_=slot_,
                 cur_=cur_):
            q, kc, vc = rnd((b, hq, 128), qdt), rnd((b, s, hkv, 128), cdt), rnd((b, s, hkv, 128), cdt)

            def lib():
                return F.scaled_dot_product_attention(
                    q[:, :, None].to(cdt), kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=valid[:, None, None, :], enable_gqa=True)

            return (lambda: kdec.decode_attention(q, kc, vc, slot_, cur_, window=window),
                    lambda: kdec.plain(q, kc, vc, slot_, cur_, window=window),
                    lib if has_gqa else None)

        # this run's data: only valid slots need K and V; a row without one, V's S slots
        n_valid, n_none = int(valid.sum()), int((~valid.any(dim=1)).sum())
        qsize, csize = (torch.tensor([], dtype=t).element_size() for t in (qdt, cdt))
        nbytes = ((2 * n_valid + s * n_none) * hkv * 128 * csize + b * hq * 128 * (qsize + csize)
                  + (b * s + b) * 4)
        types = cdtn if qdt == cdt else f"float32 q, {cdtn} cache"
        record(e_dec, cdtn == "bfloat16" and qdt == cdt and hq == 32 and window == 0 and not what,
               "decode_attention",
               f"q[{b},{hq},128] cache[{b},1024,{hkv},128] window={window} valid_slots={n_valid}"
               f"{what} splits={kdec.split_plan(b, hkv, s, hq // hkv, csize, 128)}",
               make, nbytes, 4.0 * hq * 128 * n_valid + hkv * 128 * s * n_none, cdtn,
               "float32" if qdt != cdt else cdtn, label=types)
    rows.append(e_dec)

    # --- moe_gmm: olmoe's expert products at prefill (C = 160) and decode (C = 8) with every
    # row live; decode routed as the serving path routes it (top-8 of 64 experts for 4
    # tokens: live = each expert's assignments, about 25 experts hold one); a prefill whose
    # routing leaves expert 0 empty; a ragged shape (tests/test_kernels.py:120), with every
    # row live and in two groups whose live counts include 0 and C; and the row tiles the
    # served shapes do not use ---
    e_gmm = dict(name="moe_gmm", route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
                 replaces="src/repro/kernels/moe_gmm.py:42")

    def routed(tokens, e, cap, groups=1, empty=()):
        """live int32 [E, G]: top-8 of ``e`` experts for ``tokens`` tokens in each of
        ``groups`` groups (softmax of random logits), capped at ``cap``; ``empty`` experts
        are never chosen."""
        logits = rnd((groups, tokens, e), torch.float32)
        logits[..., list(empty)] = -1e9
        top = logits.softmax(-1).topk(8, dim=-1).indices
        counts = F.one_hot(top, e).sum(dim=(1, 2))                    # [G, E]
        return counts.clamp(max=cap).T.to(torch.int32).contiguous()

    live_ragged = torch.tensor([[0, 20], [20, 0], [3, 17], [0, 0], [1, 1], [20, 20], [7, 0],
                                [11, 5]], dtype=torch.int32, device="cuda")
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for e, c, d, f, what, live in (
                (64, 8, 2048, 1024, "decode gate/up", None),
                (64, 8, 1024, 2048, "decode down", None),
                (64, 8, 2048, 1024, "decode gate/up routed", routed(SERVE_SLOTS, 64, 8)),
                (64, 160, 2048, 1024, "prefill gate/up", None),
                (64, 160, 1024, 2048, "prefill down", None),
                (64, 160, 2048, 1024, "prefill gate/up routed, expert 0 empty",
                 routed(SERVE_CACHE, 64, 160, empty=(0,))),
                (8, 40, 100, 72, "ragged", None),
                (8, 40, 100, 72, "ragged, 2 groups", live_ragged),
                # the other row tiles of tile_plan: two n8 products, and 300 rows in two tiles
                (4, 16, 64, 64, "16 rows, 2 groups", live_ragged[:4] % 9),
                (3, 300, 64, 136, "300 rows", None)):
            mask = (torch.ones((e, c), dtype=torch.bool, device="cuda") if live is None
                    else kgmm.live_rows(live, c))

            def make(e=e, c=c, d=d, f=f, dt=dt, live=live, mask=mask):
                xe, we = rnd((e, c, d), dt) * mask[..., None], rnd((e, d, f), dt) * d**-0.5
                return (lambda: kgmm.moe_gmm(xe, we, live), lambda: kgmm.plain(xe, we, live),
                        lambda: torch.bmm(xe, we))

            size = torch.tensor([], dtype=dt).element_size()
            # this run's data: the weights of experts with a live row, the live rows of xe;
            # every output row is written
            n_rows, n_exp = int(mask.sum()), int(mask.any(dim=1).sum())
            lv = "" if live is None else f" live_rows={n_rows} live_experts={n_exp}"
            record(e_gmm, dtn == "bfloat16" and what == "decode gate/up", "moe_gmm",
                   f"{what} xe[{e},{c},{d}] we[{e},{d},{f}]{lv}", make,
                   (n_rows * d + n_exp * d * f + e * c * f) * size, 2.0 * n_rows * d * f, dtn, dtn)
    rows.append(e_gmm)

    # --- hymba's attention (G = 5, head_dim 64): bf16 flash runs on the tensor cores, one
    # query head per tile; float32 on the CUDA cores, 60 of its 64 rows filled (5 heads x
    # 12 positions); prefill at 2048 with the sliding window and without it, and a ragged
    # Sq; decode on a wrapped 1024-slot ring (window 1024) and on a global cache ---
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        size = torch.tensor([], dtype=dt).element_size()
        for sq, window in ((HYMBA_CACHE, 1024), (HYMBA_CACHE, 0), (1000, 0)):  # 1000: ragged Sq
            qp, kp = torch.arange(sq, device="cuda")[:, None], torch.arange(sq, device="cuda")[None]
            allowed = (kp <= qp) & ((qp - kp < window) if window > 0 else True)

            def make(window=window, dt=dt, allowed=allowed, sq=sq):
                q, k, v = rnd((1, sq, 25, 64), dt), rnd((1, sq, 5, 64), dt), rnd((1, sq, 5, 64), dt)

                def lib():
                    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                          enable_gqa=True)

                return (lambda: kfl.flash_attention(q, k, v, causal=True, window=window),
                        lambda: kfl.plain(q, k, v, causal=True, window=window),
                        lib if has_gqa else None)

            record(e_fl, False, "flash_attention",
                   f"hymba q[1,{sq},25,64] kv[1,{sq},5,64] causal window={window}", make,
                   (2 * sq * 25 * 64 + 2 * sq * 5 * 64) * size, 4.0 * 25 * 64 * int(allowed.sum()),
                   dtn, dtn)
        # cur positions per row; the ring of 1024 slots holds positions cur-1023..cur at
        # slot position % 1024 (empty slots -1), as the hybrid prefill and decode leave it
        cur = torch.tensor([1500, 1100, 2000, 700], device="cuda", dtype=torch.int32)
        for s_len, window in ((1024, 1024), (HYMBA_CACHE, 0)):
            r = torch.arange(s_len, device="cuda")[None]
            slot = (_sliding_ring(cur + 1, s_len)[1] if window
                    else torch.where(r <= cur[:, None], r, -1).to(torch.int32))
            valid = (slot >= 0) & (slot <= cur[:, None])
            if window > 0:
                valid &= cur[:, None] - slot < window

            def make(window=window, dt=dt, valid=valid, slot=slot, s_len=s_len):
                q, kc, vc = rnd((4, 25, 64), dt), rnd((4, s_len, 5, 64), dt), rnd((4, s_len, 5, 64), dt)

                def lib():
                    return F.scaled_dot_product_attention(
                        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                        attn_mask=valid[:, None, None, :], enable_gqa=True)

                return (lambda: kdec.decode_attention(q, kc, vc, slot, cur, window=window),
                        lambda: kdec.plain(q, kc, vc, slot, cur, window=window),
                        lib if has_gqa else None)

            n_valid = int(valid.sum())
            record(e_dec, False, "decode_attention",
                   f"hymba q[4,25,64] {'ring' if window else 'global'} cache[4,{s_len},5,64] "
                   f"window={window} valid_slots={n_valid}", make,
                   2 * n_valid * 5 * 64 * size + 4 * 25 * 64 * 2 * size + (4 * s_len + 4) * 4,
                   4.0 * 25 * 64 * n_valid, dtn, dtn)

    # --- the attention modes of glm4-9b (G = 16), qwen2.5-32b (40 query heads, G = 5),
    # deepseek-67b and internvl2-76b (64 query heads, G = 8) and whisper-base (G = 1,
    # head_dim 64): flash non-causal with Sq = Sk (the encoder, 1500 frames) and Sq != Sk
    # (cross-attention, 448 text positions over 1500 frames), causal at each G and over
    # whisper's 448 text positions; decode at G = 16 (query rows in chunks of
    # ROWS_PER_BLOCK), G = 5 and G = 8, and over whisper's partly filled self cache (448
    # slots) and its cross cache (1500 slots, all valid: slot_pos 0, cur_pos 0) ---
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        size = torch.tensor([], dtype=dt).element_size()
        for what, sq, sk, hq, hkv, dh, causal in (("whisper encoder", 1500, 1500, 8, 8, 64, False),
                                                  ("whisper cross", 448, 1500, 8, 8, 64, False),
                                                  ("whisper decoder self", 448, 448, 8, 8, 64, True),
                                                  ("glm4 G=16", 1024, 1024, 32, 2, 128, True),
                                                  ("qwen2.5 G=5", 1024, 1024, 40, 8, 128, True),
                                                  ("deepseek/internvl2 G=8", 1024, 1024, 64, 8, 128,
                                                   True)):
            def make(sq=sq, sk=sk, hq=hq, hkv=hkv, dh=dh, causal=causal, dt=dt):
                q, k, v = rnd((1, sq, hq, dh), dt), rnd((1, sk, hkv, dh), dt), rnd((1, sk, hkv, dh), dt)
                lib = lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                    enable_gqa=True)
                return (lambda: kfl.flash_attention(q, k, v, causal=causal),
                        lambda: kfl.plain(q, k, v, causal=causal), lib if has_gqa else None)

            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            record(e_fl, False, "flash_attention",
                   f"{what} q[1,{sq},{hq},{dh}] kv[1,{sk},{hkv},{dh}] "
                   f"{'causal' if causal else 'non-causal'}", make,
                   (2 * sq * hq + 2 * sk * hkv) * dh * size, 4.0 * hq * dh * pairs, dtn, dtn)
        b = 4   # the 1024-slot caches filled to `fill` as above; the cross cache all valid
        part_slot = torch.where(ar < fill[:, None], ar, -1).to(torch.int32).contiguous()
        part_cur = (fill - 1).to(torch.int32)
        cross_slot = torch.zeros((b, 1500), dtype=torch.int32, device="cuda")
        cross_cur = torch.zeros((b,), dtype=torch.int32, device="cuda")
        # whisper's self cache: a row full (a request decoding past its 448 slots), two
        # partly filled, and one with the shortest prompt
        self_fill = torch.tensor([WHISPER_CACHE, 300, 70, 5], device="cuda", dtype=torch.int32)
        ar_self = torch.arange(WHISPER_CACHE, device="cuda", dtype=torch.int32)[None]
        self_slot = torch.where(ar_self < self_fill[:, None], ar_self, -1).to(torch.int32).contiguous()
        self_cur = (self_fill - 1).to(torch.int32)
        for what, s_len, hq, hkv, dh, slot_, cur_ in (
                ("glm4 G=16", 1024, 32, 2, 128, part_slot, part_cur),
                ("qwen2.5 G=5", 1024, 40, 8, 128, part_slot, part_cur),
                ("deepseek/internvl2 G=8", 1024, 64, 8, 128, part_slot, part_cur),
                ("whisper self", WHISPER_CACHE, 8, 8, 64, self_slot, self_cur),
                ("whisper cross", 1500, 8, 8, 64, cross_slot, cross_cur)):
            valid = (slot_ >= 0) & (slot_ <= cur_[:, None])

            def make(s_len=s_len, hq=hq, hkv=hkv, dh=dh, slot_=slot_, cur_=cur_, valid=valid, dt=dt):
                q, kc, vc = rnd((b, hq, dh), dt), rnd((b, s_len, hkv, dh), dt), rnd((b, s_len, hkv, dh), dt)
                lib = lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=valid[:, None, None, :], enable_gqa=True)
                return (lambda: kdec.decode_attention(q, kc, vc, slot_, cur_),
                        lambda: kdec.plain(q, kc, vc, slot_, cur_), lib if has_gqa else None)

            n_valid = int(valid.sum())
            record(e_dec, False, "decode_attention",
                   f"{what} q[{b},{hq},{dh}] cache[{b},{s_len},{hkv},{dh}] valid_slots={n_valid} "
                   f"splits={kdec.split_plan(b, hkv, s_len, hq // hkv, size, dh)}", make,
                   2 * n_valid * hkv * dh * size + 2 * b * hq * dh * size + (b * s_len + b) * 4,
                   4.0 * hq * dh * n_valid, dtn, dtn)

    # --- ssd: the prefill scans of mamba2 (x [1,1024,24,64], N = 128) and hymba
    # (x [1,2048,50,64], N = 16), chunk 128, and tests/test_kernels.py:101-104's shapes ---
    e_ssd = dict(name="ssd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
                 replaces="src/repro/kernels/ssd_scan.py:91")
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for what, b, s_len, h, p, n, chunk in (("mamba2", 1, 1024, 24, 64, 128, 128),
                                               ("hymba", 1, 2048, 50, 64, 16, 128),
                                               ("test", 2, 64, 3, 16, 8, 16),
                                               ("test", 2, 128, 4, 32, 16, 32),
                                               ("test", 2, 96, 2, 8, 4, 16)):
            def make(b=b, s_len=s_len, h=h, p=p, n=n, chunk=chunk, dt=dt):
                x = (rnd((b, s_len, h, p), torch.float32) * 0.5).to(dt)
                a = -(rnd((b, s_len, h), torch.float32) * 0.3).abs()
                bm = (rnd((b, s_len, n), torch.float32) * 0.5).to(dt)
                cm = (rnd((b, s_len, n), torch.float32) * 0.5).to(dt)
                return (lambda: kssd.ssd(x, a, bm, cm, chunk=chunk),
                        lambda: kssd.plain(x, a, bm, cm, min(chunk, s_len)), None)

            size = torch.tensor([], dtype=dt).element_size()
            l = min(chunk, s_len)
            nc = s_len // l
            # x and y, b and c in x's dtype, a and the final state in float32
            nbytes = (2 * b * s_len * h * p + 2 * b * s_len * n) * size + (b * s_len * h + b * h * p * n) * 4
            # C·Bᵀ once per chunk (shared by the heads), then per (head, chunk) the three
            # l·P-sized products: (L ⊙ C·Bᵀ)·X, C·hᵀ and Xᵀ·B. L is zero above the diagonal,
            # so the two l x l products count the l(l+1)/2 causal pairs only
            flops = b * nc * (l * (l + 1.0) * n + h * (l * (l + 1.0) * p + 4.0 * l * p * n))
            # y and the final state, held together: float32 to tests/test_kernels.py:116-117's
            # 1e-3, bf16 (y rounded to bf16) to 3e-2
            record(e_ssd, dtn == "bfloat16" and what == "mamba2", "ssd",
                   f"{what} x[{b},{s_len},{h},{p}] b/c[{b},{s_len},{n}] chunk={chunk}", make, nbytes,
                   flops, dtn, "float32", tol=1e-3 if dtn == "float32" else 3e-2)
    rows.append(e_ssd)
    return rows


def expected_launches(cfg, prefills: int, steps: int):
    """Launches per kernel of ``prefills`` prefills and ``steps`` decode steps of ``cfg``."""
    L = cfg.num_layers
    if cfg.family == "encdec":   # LayerNorms in plain torch; self- and cross-attention per layer
        return {"rmsnorm": 0, "flash_attention": (cfg.encoder_layers + 2 * L) * prefills,
                "decode_attention": 2 * L * steps, "moe_gmm": 0, "ssd": 0}
    attn, ssm = cfg.family != "ssm", cfg.family in ("ssm", "hybrid")
    return {"rmsnorm": (NORMS_PER_LAYER[cfg.family] * L + 1) * (prefills + steps),
            "flash_attention": L * prefills if attn else 0,
            "decode_attention": L * steps if attn else 0,
            "moe_gmm": 3 * L * (prefills + steps) if cfg.family == "moe" else 0,
            "ssd": L * prefills if ssm else 0}


def request_extras(torch, cfg, n: int, seed: int, device="cuda", dtype=None):
    """Per request, the prefill keywords of a vlm (``patches`` [1, P, D]) or an encdec
    model (``frames`` [1, F, D]) from a seeded generator on the card, in the model's
    dtype unless ``dtype`` says otherwise; {} for the other families."""
    key, length = {"vlm": ("patches", cfg.num_patches),
                   "encdec": ("frames", cfg.encoder_frames)}.get(cfg.family, (None, 0))
    if key is None:
        return [{} for _ in range(n)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = dtype or {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    return [{key: torch.randn((1, length, cfg.d_model), generator=gen, device="cuda")
             .to(device=device, dtype=dt)} for _ in range(n)]


def serve_depth(cfg, budget_params: int) -> int:
    """The most layers of ``cfg`` whose parameters number no more than ``budget_params``."""
    depth = cfg.num_layers
    while depth > 1 and cfg.replace(num_layers=depth).num_params() > budget_params:
        depth -= 1
    return depth


def phase_serve(torch, arch: str, timer: Timer):
    """Serve ``arch`` at full width (``DEPTH_CUT_ARCHS`` cut in depth by ``serve_depth``);
    returns its run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build
    from repro_torch.serving.batching import ContinuousBatcher, Request

    _no_tf32(torch)
    cfg = get_config(arch)
    if arch in DEPTH_CUT_ARCHS:
        depth = serve_depth(cfg, get_config(WEIGHT_BUDGET_ARCH).num_params())
        log(f"[serve] {arch}: depth cut from {cfg.num_layers} to {depth} layers "
            f"({cfg.num_params() * 2 / 1e9:.1f} GB of bf16 weights at full depth; "
            f"{WEIGHT_BUDGET_ARCH}'s at full depth, the bound of the cut, "
            f"{get_config(WEIGHT_BUDGET_ARCH).num_params() * 2 / 1e9:.1f} GB)")
        cfg = cfg.replace(num_layers=depth)
    api = build(cfg, device="cuda")
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, {api.param_count() / 1e9:.3f} B params, "
        f"{api.param_bytes() / 1e9:.2f} GB bf16, init {time.perf_counter() - t0:.2f} s")

    decode_s = [0.0]

    def timed_decode(p, c, t):
        t1 = time.perf_counter()
        out = api.decode_step(p, c, t)
        torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t1
        return out

    rng = np.random.default_rng(0)
    cache_len = {"hybrid": HYMBA_CACHE, "encdec": WHISPER_CACHE}.get(cfg.family, SERVE_CACHE)
    lens = (HYMBA_PROMPT_LENS if cfg.family == "hybrid"
            else rng.integers(4, 65, size=SERVE_REQUESTS) if cfg.family == "encdec"
            else rng.integers(64, 513, size=SERVE_REQUESTS))
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    extras = request_extras(torch, cfg, SERVE_REQUESTS, seed=1)
    extras_fn = lambda rid: extras[max(rid, 0)]

    # warm-up (cuBLAS handles, allocator): one short request on its own batcher
    warm = ContinuousBatcher(api, params, num_slots=SERVE_SLOTS, cache_len=cache_len,
                             extras_fn=extras_fn)
    warm.submit(Request(-1, prompts[0][:16], max_new_tokens=2))
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()

    batcher = ContinuousBatcher(dataclasses.replace(api, decode_step=timed_decode), params,
                                num_slots=SERVE_SLOTS, cache_len=cache_len, extras_fn=extras_fn)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    reqs = [Request(i, p, max_new_tokens=SERVE_NEW, arrival=t_start) for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    decode_tokens = 0
    while batcher.waiting or batcher.active:
        decode_tokens += len(batcher.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = ops.launch_counts()

    for r in reqs:
        toks = np.asarray(r.generated)
        if len(toks) != SERVE_NEW or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch} request {r.rid}: bad output {r.generated}")
        log(f"[serve] {arch} request {r.rid}: prompt {len(r.prompt)} tokens, TTFT "
            f"{1e3 * (r.first_token_at - t_start):.1f} ms, first tokens {r.generated[:4]}")
    expected = expected_launches(cfg, len(reqs), batcher.steps)
    log(f"[serve] {arch}: cache {cache_len}, {len(reqs)} prefills, {batcher.steps} decode steps, "
        f"{decode_tokens} decode tokens in {decode_s[0]:.3f} s of decode steps: "
        f"{decode_tokens / decode_s[0]:.1f} tokens/s, {1e3 * decode_s[0] / batcher.steps:.2f} ms/step; "
        f"wall {wall:.3f} s; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in expected.items():
        log(f"[serve] {arch} launches {name}: {counts[name]} (expected {n})")
    if counts != expected:
        raise AssertionError(f"{arch}: launch counts {counts} != expected {expected}")

    # where a prefill's and a decode step's device time goes (after the counts were read)
    prompt = prompts[0]
    room = cache_len - cfg.num_patches
    tokens = torch.tensor([prompt + [0] * (room - len(prompt))], dtype=torch.int32, device="cuda")
    plens = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    step_tokens = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    seen = profile_breakdown(torch, f"{arch} prefill", 1,
                             lambda: api.prefill(params, tokens, plens, **extras[0]))
    seen |= profile_breakdown(torch, f"{arch} decode step", 4,
                              lambda: api.decode_step(params, batcher.cache, step_tokens))
    for group, kernel, _ in KERNEL_GROUPS:
        if kernel and counts[kernel] and group not in seen:
            raise AssertionError(f"{arch}: {counts[kernel]} {kernel} launches in the serving run, "
                                 f"but the profile shows no device time in its group ({group})")
    if cfg.family == "moe":
        moe_layer_times(torch, timer, cfg, params)
    return counts


def moe_layer_times(torch, timer: Timer, cfg, params):
    """Device time of one MoE layer (routing, dispatch, the three expert products,
    combine) at the serving path's two token counts, beside its moe_gmm calls."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_slice

    mp = layer_slice(params["blocks"], 0)["moe"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for what, tokens in (("prefill", SERVE_CACHE), ("decode step", SERVE_SLOTS)):
        x = torch.randn((tokens, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        cap = moe.expert_capacity(cfg, tokens)
        # the live rows this x routes to, as the layer hands them to its moe_gmm calls
        top = moe._route(x, mp["router"], cfg.experts_per_token)[0]
        live = (torch.nn.functional.one_hot(top, cfg.num_experts).sum(dim=(0, 1)).clamp(max=cap)
                [:, None].to(torch.int32).contiguous())
        xe = torch.randn((cfg.num_experts, cap, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
        xd = torch.randn((cfg.num_experts, cap, cfg.d_ff), generator=gen,
                         device="cuda").to(torch.bfloat16)
        layer_ms, hb = timer.ms([lambda: moe.apply_moe(x, mp, cfg, group_size=tokens)])
        gmm_ms = (2 * timer.ms([lambda: ops.moe_gmm(xe, mp["w_gate"], live)])[0]
                  + timer.ms([lambda: ops.moe_gmm(xd, mp["w_down"], live)])[0])
        log(f"[profile] {cfg.name} MoE layer, {what} ({tokens} tokens, capacity {cap}, "
            f"{int((live > 0).sum())} experts routed to): {layer_ms:.4f} ms"
            f"{' (host-bound)' if hb else ''}, of which its three moe_gmm calls {gmm_ms:.4f} ms "
            f"(device time, weights L2-cold)")


# (group, the kernel (ops name) it belongs to, substrings of its device kernels' names);
# the first group whose substring a kernel's name holds takes it
KERNEL_GROUPS = (("rmsnorm kernel", "rmsnorm", ("rmsnorm_kernel",)),
                 ("flash kernel", "flash_attention", ("flash_kernel",)),
                 ("decode kernel", "decode_attention", ("decode_kernel",)),
                 ("moe_gmm kernel", "moe_gmm", ("gmm_wgmma_kernel", "gmm_f32_kernel")),
                 ("ssd kernel", "ssd", ("ssd_chunk_kernel", "ssd_state_kernel", "ssd_out_kernel")),
                 ("matmul (cuBLAS)", None, ("gemm", "nvjet", "cutlass", "xmma")))


def card_clocks() -> str:
    """The card's SM clock, its maximum and the power drawn, as nvidia-smi reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "not read"


# a profile runs at least this long, so that the card's clocks have left idle
MIN_PROFILE_MS = 200.0


def profile_breakdown(torch, what: str, reps: int, fn):
    """Device time per call of ``fn`` by kernel group (torch.profiler), over ``reps``
    calls or as many more as take ``MIN_PROFILE_MS``, the share of the wall time the
    device was idle under the profiler, and the SM clock and power just before and
    just after; returns the groups that showed device time. Raises if the profiler
    saw no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(reps, math.ceil(MIN_PROFILE_MS / (1e3 * (time.perf_counter() - t0))))
    before = card_clocks()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    after = card_clocks()
    groups, launches, others = {}, {}, []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        name = next((g for g, _, keys in KERNEL_GROUPS if any(k in ev.key for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / reps
        launches[name] = launches.get(name, 0) + ev.count / reps
        if name == "other":
            others.append((us / 1e3 / reps, ev.count / reps, ev.key))
    busy = sum(groups.values())
    if busy == 0.0:
        raise AssertionError(f"{what}: the profiler recorded no device kernels")
    parts = ", ".join(f"{g} {ms:.3f} ms ({launches[g]:.0f} launches)"
                      for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[profile] {what}: {reps} calls; per call wall {wall_ms:.3f} ms under the profiler, "
        f"device busy {busy:.3f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}; {parts}")
    log(f"[profile] {what}: SM clock, max SM clock, power: before [{before}], after [{after}]")
    top = "; ".join(f"{ms:.3f} ms ({n:.0f}) {key[:90]}" for ms, n, key in sorted(others)[::-1][:4])
    log(f"[profile] {what}: largest in other: {top}")
    return {g for g, ms in groups.items() if ms > 0.0}


def cast_params(params, template, device, dtype):
    """``params`` on ``device`` in ``dtype``, except the leaves whose spec fixes a dtype:
    the MoE router stays float32, as in the reference's bf16 model."""
    from repro_torch.models.common import torch_dtype, tree_items, tree_map_with_path

    specs = dict(tree_items(template))
    return tree_map_with_path(
        lambda path, t: t.to(device=device, dtype=torch_dtype(specs[path].dtype)
                             if specs[path].dtype else dtype), params)


def phase_reference(torch):
    for arch in REFERENCE_ARCHS:
        reference_model(torch, arch)
    reference_batcher(torch, "granite-8b", cache_len=128, prompt_lens=None, max_new=8)
    # request 0 fills 440 of the 448 slots and decodes 16 tokens: past the cache, where the
    # self-attention overwrites slot min(pos, S-1) and the position row is clamped
    reference_batcher(torch, "whisper-base", cache_len=WHISPER_CACHE,
                      prompt_lens=(440, 12, 64, 5, 200, 33), max_new=16)


def reference_model(torch, arch: str):
    """``arch`` at full width cut to 2 layers (an encdec model whole), on the card
    (float32 and bf16, through the kernels) against the CPU's float32 plain run: the
    logits of a prefill and 4 decode steps; for MoE, also the share of (token, layer)
    top-k expert sets that the card routed differently; for SSM and hybrid, also the
    final SSM state. A QKV bias is drawn non-zero (the template's zeros would hide
    it); a vlm gets its patches and an encdec model its frames, from a seeded generator.

    hymba keeps layer 0 global and lets layer 1 slide, and runs a 1300-token prompt
    in a 2048 cache: the window (1024) bites in the prefill and in the decode ring."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build

    _no_tf32(torch)
    cfg = get_config(arch)
    if cfg.family != "encdec":
        cfg = cfg.replace(num_layers=2)
    plen, n_dec, seq = 128, 4, 136   # 8 pad tokens after the prompt
    if cfg.family == "hybrid":
        cfg = cfg.replace(global_attn_layers=(0,))
        plen, seq = 1300, HYMBA_CACHE
    rng = np.random.default_rng(1)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(1, seq)), dtype=torch.int32)
    plens = torch.tensor([plen], dtype=torch.int32)
    gpu = build(cfg, device="cuda")
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    if cfg.qkv_bias:
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name in ("bq", "bk", "bv"):
            params["blocks"]["attn"][name].normal_(0.0, 0.5, generator=gen)
    extras = request_extras(torch, cfg, 1, seed=2, device="cpu", dtype=torch.float32)[0]
    cpu = build(cfg, device="cpu")
    params_cpu = cast_params(params, cpu.param_template, "cpu", torch.float32)

    forced = rng.integers(0, cfg.vocab_size, size=n_dec).tolist()  # teacher-forced tokens
    routes = []  # per run: the sorted top-k expert ids of every _route call, in call order
    real_route = moe._route

    def recording_route(x, router, k):
        out = real_route(x, router, k)
        routes[-1].append(out[0].sort(dim=-1).values.reshape(-1, k).cpu())
        return out

    def run(api, p, device, dtype):
        """(logits of the prefill and each decode step, the final SSM state h or None)."""
        routes.append([])
        p = cast_params(p, api.param_template, device, dtype)
        logits, cache = api.prefill(p, prompt.to(device), plens.to(device),
                                    **{k: v.to(device=device, dtype=dtype) for k, v in extras.items()})
        outs = [logits.float().cpu()]
        for tok in forced:
            logits, cache = api.decode_step(p, cache, torch.tensor([tok], dtype=torch.int32, device=device))
            outs.append(logits.float().cpu())
        return torch.cat(outs), (cache["ssm"]["h"].cpu() if "ssm" in cache else None)

    moe._route = recording_route
    try:
        with torch.inference_mode():
            want, want_h = run(cpu, params_cpu, "cpu", torch.float32)
            want_routes = routes[-1]
            for dtn, dt, rtol, atol in (("float32", torch.float32, 2e-3, 2e-3),
                                        ("bfloat16", torch.bfloat16, 5e-2, 5e-1)):
                got, got_h = run(gpu, params, "cuda", dt)
                err = (got - want).abs().max().item()
                top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
                ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all()) and top1 >= 0.6
                note = ""
                if cfg.family == "moe":
                    if len(routes[-1]) != len(want_routes):
                        raise AssertionError(f"{arch}: {len(routes[-1])} routing calls on the card, "
                                             f"{len(want_routes)} on the CPU")
                    differ = sum(int((g != w).any(dim=-1).sum()) for g, w in zip(routes[-1], want_routes))
                    total = sum(w.shape[0] for w in want_routes)
                    share = differ / total
                    ok = ok and share <= MAX_ROUTE_DIFF[dtn]
                    note = (f", top-{cfg.experts_per_token} expert sets differing in {differ} of "
                            f"{total} (token, layer) rows = {share:.4f} (need <= "
                            f"{MAX_ROUTE_DIFF[dtn]})")
                if want_h is not None:   # |h| < 1 here: the logits' atol would say nothing
                    h_err = (got_h - want_h).abs().max().item()
                    h_tol = STATE_TOL[dtn]
                    ok = ok and bool(((got_h - want_h).abs() <= h_tol + h_tol * want_h.abs()).all())
                    note += (f", final SSM state {tuple(want_h.shape)} max_abs_err {h_err:.3e} "
                             f"(rtol=atol={h_tol}; |h| max {want_h.abs().max().item():.3e})")
                log(f"[reference] {arch} {cfg.num_layers}-layer full width, prompt {plen} in {seq}"
                    f"{''.join(f', {k} {list(v.shape)}' for k, v in extras.items())}, card {dtn} via "
                    f"kernels vs CPU float32 plain: max_abs_err {err:.3e} (rtol={rtol}, atol={atol}), "
                    f"top-1 agreement {top1:.2f} over {got.shape[0]} positions (need >= 0.6){note} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{arch}: the model on the card disagrees with the CPU ({dtn})")
    finally:
        moe._route = real_route


def reference_batcher(torch, arch: str, cache_len: int, prompt_lens, max_new: int):
    """A float32 ``arch`` (full width, 2 layers; an encdec model whole) served through the
    batcher on the card, 6 requests of ``prompt_lens`` tokens (None: 8 to 96, drawn);
    the token streams must equal the CPU batcher's. A decoder-only model's decode
    steps send float32 queries against its bf16 cache; an encdec cache is float32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build
    from repro_torch.serving.batching import ContinuousBatcher, Request

    cfg = get_config(arch).replace(dtype="float32")
    if cfg.family != "encdec":
        cfg = cfg.replace(num_layers=2)
    gpu, cpu = build(cfg, device="cuda"), build(cfg, device="cpu")
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
    params_cpu = cast_params(params, cpu.param_template, "cpu", torch.float32)
    rng = np.random.default_rng(2)
    lens = rng.integers(8, 97, size=6) if prompt_lens is None else prompt_lens
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    extras = request_extras(torch, cfg, len(prompts), seed=3, dtype=torch.float32)

    def serve(api, p):
        ex = [{k: v.to(api.device) for k, v in e.items()} for e in extras]
        batcher = ContinuousBatcher(api, p, num_slots=SERVE_SLOTS, cache_len=cache_len,
                                    extras_fn=lambda rid: ex[rid])
        for i, pr in enumerate(prompts):
            batcher.submit(Request(i, pr, max_new_tokens=max_new))
        return batcher.run_to_completion(), batcher.steps

    ops.reset_launch_counts()
    got, steps = serve(gpu, params)
    counts = ops.launch_counts()
    want, _ = serve(cpu, params_cpu)
    expected = expected_launches(cfg, len(prompts), steps)["decode_attention"]
    ok = got == want and counts["decode_attention"] == expected > 0
    same = sum(g == w for r in want for g, w in zip(got[r], want[r]))
    past = sum(len(pr) + max_new - 1 > cache_len for pr in prompts)
    log(f"[reference] {arch} {cfg.num_layers}-layer float32 through the batcher "
        f"({'float32' if cfg.family == 'encdec' else 'bf16'} cache of {cache_len}, {past} "
        f"request(s) decoding past it): card vs CPU token streams equal: {got == want} ({same} of "
        f"{sum(map(len, want.values()))} tokens equal over {len(want)} requests, {steps} decode "
        f"steps, {counts['decode_attention']} decode kernel launches, expected {expected}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch}: float32 batcher on the card disagrees with the CPU batcher")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    t0 = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    timer = Timer(torch)
    kernels = phase_kernels(torch, timer)
    torch.cuda.empty_cache()
    counts = {}  # launches summed over the main paths' runs
    for arch in SERVE_ARCHS:
        for name, n in phase_serve(torch, arch, timer).items():
            counts[name] = counts.get(name, 0) + n
        gc.collect()  # free one model before the next is built
        torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] = counts[k["name"]]
    phase_reference(torch)
    log(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
