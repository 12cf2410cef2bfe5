#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each of which raises on failure (the script then exits non-zero):

  0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  1. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for sm_90a;
  2. kernels: each hand-written kernel against its plain PyTorch version at
     the main paths' shapes (granite-8b's, olmoe-1b-7b's, mamba2-130m's,
     hymba-1.5b's, glm4-9b's G = 16, qwen2.5-32b's G = 5 at 40 query heads,
     deepseek's and internvl2's G = 8 at 64, qwen3-moe-235b-a22b's G = 16 at 64
     query heads over 4 KV heads and its 128-expert ``moe_gmm`` (D 4096, F 1536,
     top-8), and whisper-base's non-causal
     encoder and cross-attention, causal decoder self-attention, partly filled
     self cache and all-valid cross cache), in bf16 and f32, with kernel, plain and library device
     times (``Timer``) and the card's bound for the same work;
  3. serving, once per model: granite-8b, glm4-9b, qwen2.5-32b, deepseek-67b
     (dense; deepseek cut to 44 of 95 layers), olmoe-1b-7b (MoE), mamba2-130m
     (SSM), hymba-1.5b (hybrid, cache 2048 so that its sliding layers hold a
     ring of 1024), internvl2-76b (vlm, cut to 35 of 80 layers, 256 patches a
     request), qwen3-moe-235b-a22b (MoE, 128 experts, cut to 12 of 94 layers)
     and whisper-base (encdec, cache 448, 1500 frames a request) at
     full width in bf16, random weights from a seeded generator, 8 requests
     through ``ContinuousBatcher`` (4 slots); launch counters, set to 0 just
     before each run and read just after, must equal the expected counts;
     then a profile of one prefill and a few decode steps by kernel group
     (and, for olmoe, the MoE layer's device time);
  4. the models against the plain CPU reference, each at full width cut to
     2 layers (whisper-base whole): a prefill plus 4 decode steps, on the
     card through the kernels and on the CPU through the plain versions
     (granite, glm4, qwen2.5 with non-zero QKV biases, olmoe, mamba2,
     internvl2 with its patches, qwen3-moe and whisper with its frames on a 128-token
     prompt, hymba on a 1300-token prompt in a 2048 cache with layer 1
     sliding; the logits, for olmoe also the share of tokens routed to
     another set of experts, for mamba2 and hymba also the final SSM state);
     and a float32 granite (float32 queries against its bf16 cache) and a
     float32 whisper-base (one request decoding past its 448-slot cache)
     served through the batcher on the card, with the CPU batcher's tokens;
  5. platform, right after granite-8b's serving run in phase 3, on its model
     and weights: Dandelion's Table 1 on the card (``repro_torch.core``'s
     dandelion, snapshot and microvm backends with the code in RAM and on
     disk, over a 1x1 float32 matmul and an 8-layer tanh MLP; each payload's
     first microvm boot of the process timed apart; outputs against the eager
     payload; dandelion < snapshot < microvm on the MLP), a payload that
     returns with ~20 ms of device work queued billed at least that long by a
     ``WorkerNode``, granite-8b served through the ``serve_lm`` composition
     on a ``WorkerNode`` (tokens equal to the batcher run directly, exact
     launch counts, which join the ``kernels`` line's), the same composition
     declared through ``repro_torch.sdk`` on an ``sdk.Platform`` of one node and
     on an elastic cluster of 1-2 nodes (tokens, exact counts, which join the
     ``kernels`` line's, each request's virtual latency at least its payload's
     wall), the MLP as an ``sdk.function`` ``torch_fn`` payload on a snapshot
     node against the eager payload, ``sdk.verify`` listing ``generate`` as
     unsafe, and ``trace_capture``'s CUDA-event step calibration at batches 1,
     2 and 4;
  6. train: (a) the ``autograd.Function`` of rmsnorm and of flash attention
     (the kernel forward, the gradient formula backward) against autograd of
     the plain version, at granite-8b's training shapes and whisper-base's
     cross-attention, bf16 and f32, with forward+backward device times; (b)
     ``train_loss`` and every leaf's gradient of granite-8b (full width, 2
     layers) and whisper-base on the card in float32 and bf16 against the
     CPU's float32, and olmoe-1b-7b and mamba2-130m refusing autograd (their
     kernels have no backward); (c) granite-8b at full width cut to 16 layers
     (its training state in 60 GB) trained for 10 steps at seq 4096, global
     batch 8 in 4 micro-batches, remat "full", with exact launch counts; (d)
     ``python -m repro_torch.training.train_lm``'s composition on
     ``sdk.Platform`` (lm-100m), crashed at step 20 and resumed, under
     deterministic algorithms: its losses equal an uninterrupted run's, and
     that run's last checkpoint restores on the CPU into its state.
  7. launch: (a) ``python -m repro_torch.launch.serve``'s ``run`` with the CLI's
     defaults (16 requests, 8 slots, cache 64, 12 new tokens) on granite-8b and
     whisper-base (1500 frames a request) at full width, its tokens equal to the
     batcher's run directly, exact launch counts; (b) ``launch.train``'s ``run``
     on whisper-base at full width (seq 448, batch 8), 30 steps straight, then 20
     and a restart to 30 from the checkpoint, under deterministic algorithms: the
     restarted losses equal the straight run's bitwise, exact flash counts; (c)
     ``apps.inference_service`` for granite-8b priced on ``H100_SXM`` beside phase
     5's measured decode steps, none of which may beat its roofline term.
     ``launch.train`` runs on a (1, 1) mesh through ``jit_train_step``.
  8. sharded, on a (1, 1) NCCL mesh: (a) ``jit_serve_steps`` on granite-8b
     (bf16, full depth and width), a prefill of 4 prompts and 16 decode steps,
     against ``build_serve_steps`` on the same weights: logits and tokens
     bitwise equal, exact launch counts, each decode step timed with CUDA
     events through DTensor and plain; (b) ``jit_train_step`` with ZeRO-3 on
     granite-8b at full width cut to 4 of 36 layers (seq 1024 x batch 4,
     remat "full", 3 steps, deterministic algorithms) against
     ``build_train_step``: losses, grad norms and every leaf bitwise equal,
     exact counts; (c) ``compress_psum`` over the NCCL group on (b)'s
     gradient leaves, equal to ``tree_compress_with_feedback`` bitwise.
  9. dryrun: (a) ``python -m repro_torch.launch.dryrun --arch all --shape all --mesh
     both`` as a child process (the production meshes on torch's fake process
     group, ``meta`` tensors): no cell fails, the skipped cells are exactly the
     ones ``applicability`` skips, one line a cell (bottleneck, counted FLOPs over
     ``model_flops``, peak bytes a device against the card's 80 GB); (b) phase
     8(a)'s granite-8b prefill and one decode step on a (1, 1) NCCL mesh, counted on
     ``meta`` tensors through ``launch.dryrun.run_cell`` and live on the card under
     the same ``CostCounter``: FLOPs, bytes and per-kernel calls equal; each step's
     ``H100_SXM`` roofline beside its CUDA-event time, plain and through DTensor,
     none faster than its roofline.

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

TOL = {"bfloat16": 3e-2, "float32": 2e-3}    # tests/test_kernels.py::_tol
SERVE_SLOTS, SERVE_CACHE, SERVE_REQUESTS, SERVE_NEW = 4, 1024, 8, 32
SERVE_ARCHS = ("granite-8b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b", "glm4-9b", "qwen2.5-32b",
               "deepseek-67b", "internvl2-76b", "qwen3-moe-235b-a22b", "whisper-base")
# deepseek-67b (134.9 GB of bf16 weights, the reference's num_params), internvl2-76b
# (141.2 GB) and qwen3-moe-235b-a22b (470.2 GB) do not fit the card's 80 GB at full
# depth: each is served at the deepest cut whose weights are no larger than those of
# qwen2.5-32b at full depth (65.5 GB), which the card serves with its cache and
# activations (``serve_depth``: 44, 35 and 12 layers); widths are never cut
DEPTH_CUT_ARCHS = ("deepseek-67b", "internvl2-76b", "qwen3-moe-235b-a22b")
WEIGHT_BUDGET_ARCH = "qwen2.5-32b"
WHISPER_CACHE = 448   # Whisper's text context
# phase 4: every model but deepseek-67b (the same dense code as glm4 and qwen2.5)
REFERENCE_ARCHS = ("granite-8b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b", "glm4-9b",
                   "qwen2.5-32b", "internvl2-76b", "qwen3-moe-235b-a22b", "whisper-base")
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
# phase 5 (platform): granite-8b's model and weights, after its serving run
PLATFORM_ARCH, PLATFORM_REQUESTS, PLATFORM_NEW = "granite-8b", 4, 16
CALIBRATION_BATCHES = (1, 2, 4)
MLP_LAYERS, MLP_WIDTH = 8, 64          # tests/test_coldstart.py's MLP
TABLE1_SAMPLES = {"dandelion": 9, "snapshot": 9, "microvm": 3}
SLEEP_MS = 20.0                        # device time of the billing check's payload
# phase 4: the final SSM state, card against CPU (tests/test_kernels.py::_tol in float32;
# in bf16 every activation of the stack is rounded, as for the logits' 5e-2)
STATE_TOL = {"bfloat16": 5e-2, "float32": 2e-3}
# phase 6 (train): (a) the kernels' gradients at granite-8b's training shapes and whisper's
# cross-attention; (b) the relative norm error of each leaf's gradient, card against
# the CPU's float32; (c) granite-8b at full width, cut to the deepest whose training
# state (bf16 parameters and gradients, two float32 moments, the float32 accumulation
# buffer: 16 bytes a parameter) fits 60 GB of the card's 80, trained at TRAIN_4K's seq
# 4096, global batch 8 in 4 micro-batches; (d) train_lm's crash and resume
TRAIN_RMS_SHAPE = (2, 4096, 4096)
TRAIN_FLASH_CASES = (("granite", 2, 4096, 4096, 32, 8, 128, True),
                     ("whisper cross", 1, 448, 1500, 8, 8, 64, False))
GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_ARCH, TRAIN_BUDGET_BYTES, TRAIN_BYTES_PER_PARAM = "granite-8b", 60e9, 16
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_LR = 8, 4, 10, 1e-3
TRAIN_LM_STEPS = 40
# phase 7 (launch): the CLIs' run() at full width; whisper-base is the one trainable
# family whose full depth and width train on one card (70.7 M parameters, ~1.1 GB of
# state); the encdec family has no remat, so "--remat full" changes nothing there.
# --lr 1e-2 in the 100-step warmup gives AdamW steps of 1e-4..3e-3, above a bf16
# weight's ulp (1.2e-4 at 0.02): at the default 3e-4 most bf16 weights would not
# move, and a restart from the wrong state could still give the same losses
LAUNCH_SERVE_ARCHS = ("granite-8b", "whisper-base")
LAUNCH_TRAIN_ARCH, LAUNCH_TRAIN_STEPS = "whisper-base", (20, 30)
LAUNCH_TRAIN_FLAGS = ("--seq", "448", "--batch", "8", "--remat", "full", "--ckpt-every", "10",
                      "--lr", "1e-2")
# phase 8 (sharded): the sharded steps on a (1, 1) NCCL mesh against the plain steps on the
# same weights, bitwise. (a) granite-8b whole, a prefill of 4 prompts in a 1024 cache, then
# 16 decode steps; (b) ZeRO-3 training of granite-8b at full width cut to 4 of 36 layers,
# seq 1024 x batch 4, 3 steps, remat "full", under deterministic algorithms
SHARDED_ARCH, SHARDED_PROMPTS, SHARDED_DECODE = "granite-8b", 4, 16
SHARDED_TRAIN_LAYERS, SHARDED_TRAIN_SEQ, SHARDED_TRAIN_BATCH, SHARDED_TRAIN_STEPS = 4, 1024, 4, 3
# phase 9: the dry-run's grid (one worker process a core), and the timed repeats of each
# step in (b)
DRYRUN_MESH, DRYRUN_TIMEOUT_S, DRYRUN_REPEATS = "both", 480, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_spec():
    """The published constants of one H100 SXM at its 700 W limit
    (``repro_torch.config.parallel.H100_SXM``, NVIDIA's data sheet, dense)."""
    from repro_torch.config.parallel import H100_SXM
    return H100_SXM


def peak_flops(op_type: str) -> float:
    spec = card_spec()
    return {"bfloat16": spec.peak_flops, "float32": spec.peak_flops_f32}[op_type]


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
    L2 (under ``H100_SXM.l2_bytes / MAX_COPIES`` a call: the decode rmsnorm, the
    ragged test shapes); its time is then flagged ``L2-warm``. If the host
    takes longer to enqueue than the sleep lasts, the time is flagged
    ``host-bound`` (it then includes host gaps).
    """

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
        return min(cls.MAX_COPIES, max(cls.MIN_COPIES, math.ceil(2 * card_spec().l2_bytes / nbytes)))

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
    t_bytes = nbytes / card_spec().hbm_bandwidth * 1e3
    t_ops = flops / peak_flops(op_type) * 1e3
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
    log(f"[card] bounds use {variant}'s peaks: {card_spec().hbm_bandwidth / 1e12} TB/s, "
        f"{peak_flops('bfloat16') / 1e12:.0f} TFLOP/s bf16, {peak_flops('float32') / 1e12:.0f} "
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

    def meta(shape, dt):
        """A stand-in of the shape and dtype for a kernel's ``cost``, the one formula of
        its bound (``launch.hlo_counter`` counts by it too)."""
        return torch.empty(shape, dtype=dt, device="meta")

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
        warm = len(sets) * nbytes < card_spec().l2_bytes
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

            c = krms.cost(meta(shape, dt), meta(shape[-1:], dt))
            record(e_rms, dtn == "bfloat16" and shape == (1, 1024, 4096), "rmsnorm", str(shape),
                   make, c.bytes, c.flops, dtn,
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

            # q and out, k and v; QK^T and PV on the allowed pairs
            c = kfl.cost(meta((1, sq, hq, 128), dt), meta((1, sq, hkv, 128), dt),
                         meta((1, sq, hkv, 128), dt), causal=True, window=window)
            record(e_fl, dtn == "bfloat16" and hq == 32 and sq == 1024 and window == 0,
                   "flash_attention", f"q[1,{sq},{hq},128] kv[1,{sq},{hkv},128] causal window={window}",
                   make, c.bytes, c.flops, dtn, dtn)
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
        csize = torch.tensor([], dtype=cdt).element_size()
        c = kdec.cost(meta((b, hq, 128), qdt), meta((b, s, hkv, 128), cdt), meta((b, s, hkv, 128), cdt),
                      meta((b, s), torch.int32), meta((b,), torch.int32), valid=n_valid,
                      rows_without=n_none)
        types = cdtn if qdt == cdt else f"float32 q, {cdtn} cache"
        record(e_dec, cdtn == "bfloat16" and qdt == cdt and hq == 32 and window == 0 and not what,
               "decode_attention",
               f"q[{b},{hq},128] cache[{b},1024,{hkv},128] window={window} valid_slots={n_valid}"
               f"{what} splits={kdec.split_plan(b, hkv, s, hq // hkv, csize, 128)}",
               make, c.bytes, c.flops, cdtn, "float32" if qdt != cdt else cdtn, label=types)
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
                # qwen3-moe-235b-a22b: 128 experts, top-8 of d_ff 1536 at d_model 4096;
                # capacity 8 at decode, 80 at a 1024-token prefill
                (128, 8, 4096, 1536, "qwen3-moe decode gate/up routed",
                 routed(SERVE_SLOTS, 128, 8)),
                (128, 80, 4096, 1536, "qwen3-moe prefill gate/up routed",
                 routed(SERVE_CACHE, 128, 80)),
                (128, 80, 1536, 4096, "qwen3-moe prefill down", None),
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

            # this run's data: the weights of experts with a live row, the live rows of xe;
            # every output row is written
            n_rows, n_exp = int(mask.sum()), int(mask.any(dim=1).sum())
            lv = "" if live is None else f" live_rows={n_rows} live_experts={n_exp}"
            cost = kgmm.cost(meta((e, c, d), dt), meta((e, d, f), dt), rows=n_rows, experts=n_exp)
            record(e_gmm, dtn == "bfloat16" and what == "decode gate/up", "moe_gmm",
                   f"{what} xe[{e},{c},{d}] we[{e},{d},{f}]{lv}", make, cost.bytes, cost.flops,
                   dtn, dtn)
    rows.append(e_gmm)

    # --- hymba's attention (G = 5, head_dim 64): bf16 flash runs on the tensor cores, one
    # query head per tile; float32 on the CUDA cores, 60 of its 64 rows filled (5 heads x
    # 12 positions); prefill at 2048 with the sliding window and without it, and a ragged
    # Sq; decode on a wrapped 1024-slot ring (window 1024) and on a global cache ---
    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
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

            c = kfl.cost(meta((1, sq, 25, 64), dt), meta((1, sq, 5, 64), dt),
                         meta((1, sq, 5, 64), dt), causal=True, window=window)
            record(e_fl, False, "flash_attention",
                   f"hymba q[1,{sq},25,64] kv[1,{sq},5,64] causal window={window}", make,
                   c.bytes, c.flops, dtn, dtn)
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
            c = kdec.cost(meta((4, 25, 64), dt), meta((4, s_len, 5, 64), dt),
                          meta((4, s_len, 5, 64), dt), meta((4, s_len), torch.int32),
                          meta((4,), torch.int32), valid=n_valid)
            record(e_dec, False, "decode_attention",
                   f"hymba q[4,25,64] {'ring' if window else 'global'} cache[4,{s_len},5,64] "
                   f"window={window} valid_slots={n_valid}", make, c.bytes, c.flops, dtn, dtn)

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
                                                   True),
                                                  ("qwen3-moe G=16", 1024, 1024, 64, 4, 128, True)):
            def make(sq=sq, sk=sk, hq=hq, hkv=hkv, dh=dh, causal=causal, dt=dt):
                q, k, v = rnd((1, sq, hq, dh), dt), rnd((1, sk, hkv, dh), dt), rnd((1, sk, hkv, dh), dt)
                lib = lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                    enable_gqa=True)
                return (lambda: kfl.flash_attention(q, k, v, causal=causal),
                        lambda: kfl.plain(q, k, v, causal=causal), lib if has_gqa else None)

            c = kfl.cost(meta((1, sq, hq, dh), dt), meta((1, sk, hkv, dh), dt),
                         meta((1, sk, hkv, dh), dt), causal=causal)
            record(e_fl, False, "flash_attention",
                   f"{what} q[1,{sq},{hq},{dh}] kv[1,{sk},{hkv},{dh}] "
                   f"{'causal' if causal else 'non-causal'}", make, c.bytes, c.flops, dtn, dtn)
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
                ("qwen3-moe G=16", 1024, 64, 4, 128, part_slot, part_cur),
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
            c = kdec.cost(meta((b, hq, dh), dt), meta((b, s_len, hkv, dh), dt),
                          meta((b, s_len, hkv, dh), dt), meta((b, s_len), torch.int32),
                          meta((b,), torch.int32), valid=n_valid)
            record(e_dec, False, "decode_attention",
                   f"{what} q[{b},{hq},{dh}] cache[{b},{s_len},{hkv},{dh}] valid_slots={n_valid} "
                   f"splits={kdec.split_plan(b, hkv, s_len, hq // hkv, size, dh)}", make,
                   c.bytes, c.flops, dtn, dtn)

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

            # x and y, b and c in x's dtype, a and the final state in float32; the causal
            # pairs of the two l x l products only
            c = kssd.cost(meta((b, s_len, h, p), dt), meta((b, s_len, h), torch.float32),
                          meta((b, s_len, n), dt), meta((b, s_len, n), dt), chunk=chunk)
            # y and the final state, held together: float32 to tests/test_kernels.py:116-117's
            # 1e-3, bf16 (y rounded to bf16) to 3e-2
            record(e_ssd, dtn == "bfloat16" and what == "mamba2", "ssd",
                   f"{what} x[{b},{s_len},{h},{p}] b/c[{b},{s_len},{n}] chunk={chunk}", make, c.bytes,
                   c.flops, dtn, "float32", tol=1e-3 if dtn == "float32" else 3e-2)
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
    returns its run's launch counts and the model it served, (cfg, api, params)."""
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
    return counts, (cfg, api, params)


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


# ---------------------------------------------------------------------------
# phase 5: the Dandelion worker node and SDK on the card
# ---------------------------------------------------------------------------
def _mlp(torch):
    """The 8-layer, width-64 tanh MLP of tests/test_coldstart.py, float32 weights
    from a seeded generator on the card, and an input of 4 rows: (mlp, x)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    ws = torch.randn((MLP_LAYERS, MLP_WIDTH, MLP_WIDTH), generator=gen, device="cuda") * 0.2

    def mlp(x):
        for i in range(MLP_LAYERS):
            x = torch.tanh(x @ ws[i])
        return x

    return mlp, torch.randn((4, MLP_WIDTH), generator=gen, device="cuda")


def _table1_registry(torch):
    """Two payloads on the card, each with its eager body as the dandelion
    function: the paper's Table-1 1x1 matmul, in float32 (CUDA has no integer
    matmul; the reference's is int64), and ``_mlp``."""
    from repro_torch.core import FunctionRegistry, Item

    def matmul(x):
        return x @ x

    mlp, x_mlp = _mlp(torch)
    reg = FunctionRegistry()
    payloads = {}
    for name, fn, x in (("matmul_1", matmul, torch.ones((1, 1), device="cuda")),
                        ("mlp", mlp, x_mlp)):
        def body(inputs, fn=fn):
            return {"out": [Item(fn(torch.as_tensor(inputs["x"][0].data, device="cuda")).cpu()
                                 .numpy())]}

        reg.register_function(name, body, torch_fn=fn, example_args=(torch.zeros_like(x),),
                              context_bytes=1 << 20)
        payloads[name] = ({"x": [Item(x.cpu().numpy())]}, fn(x).cpu())
    return reg, payloads


def platform_table1(torch):
    """Table 1 on the card: every backend with the code in the RAM cache and on
    disk (``benchmarks/table1_coldstart.py``), medians of ``TABLE1_SAMPLES``; each
    payload's first microvm boot of the process timed apart; each backend's
    output against the eager payload's."""
    from repro_torch.core import BACKENDS, cold_start, measure

    reg, payloads = _table1_registry(torch)
    totals = {}
    for name, (inputs, want) in payloads.items():
        t0 = time.perf_counter()
        ctx, bd, _ = cold_start(reg, name, inputs, backend="microvm", device="cuda")
        ctx.free()
        log(f"[platform] table1 {name} microvm first boot of the process: execute_setup "
            f"{bd.execute_setup * 1e6:.0f} us ({time.perf_counter() - t0:.2f} s; Inductor's "
            f"start-up and first code generation for this payload)")
        for backend in BACKENDS:
            for cached in (True, False):
                if not cached:
                    reg.evict(name)
                bd, exec_s = measure(reg, name, inputs, backend=backend, cached=cached,
                                     samples=TABLE1_SAMPLES[backend], device="cuda")
                us = bd.us()
                totals[(name, backend, cached)] = bd.total
                log(f"[platform] table1 {name} {backend} {'ram' if cached else 'disk'} "
                    f"(median of {TABLE1_SAMPLES[backend]}): marshal {us['marshal_us']:.1f} us, "
                    f"load {us['load_us']:.1f}, transfer {us['transfer_us']:.1f}, execute_setup "
                    f"{us['execute_setup_us']:.1f}, output {us['output_us']:.1f}; total "
                    f"{us['total_us']:.1f} us; execute {exec_s * 1e6:.1f} us")
            ctx, _, run = cold_start(reg, name, inputs, backend=backend, device="cuda")
            got = torch.as_tensor(run()["out"][0].data)
            ctx.free()
            err = (got - want).abs().max().item()
            ok = got.shape == want.shape and err <= TOL["float32"]
            log(f"[platform] table1 {name} {backend}: output vs the eager payload max_abs_err "
                f"{err:.3e} (tolerance {TOL['float32']}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: the {backend} backend's output disagrees")
    for cached in (True, False):
        d, s, m = (totals[("mlp", b, cached)] for b in BACKENDS)
        ok = d < s < m
        log(f"[platform] table1 mlp {'ram' if cached else 'disk'}: dandelion {d * 1e6:.1f} us < "
            f"snapshot {s * 1e6:.1f} us < microvm {m * 1e6:.1f} us: {ok}")
        if not ok:
            raise AssertionError("Table 1 ordering dandelion < snapshot < microvm fails on the MLP")


def platform_billing(torch):
    """A payload that returns with ~``SLEEP_MS`` of device work queued
    (``torch.cuda._sleep``) must be billed at least that long by the node."""
    from repro_torch.core import Composition, FunctionRegistry, Item, WorkerNode

    clocks = card_clocks()
    max_mhz = float(clocks.split(",")[1].split()[0])
    cycles = int(SLEEP_MS * max_mhz * 1e3)  # at the maximum SM clock; longer at a lower one
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    launch_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()

    def sleep(inputs):
        torch.cuda._sleep(cycles)
        return {"out": [Item(torch.ones(4, device="cuda"))]}

    reg = FunctionRegistry()
    reg.register_function("sleep", sleep, memoize=False, pure_unsafe=True)
    app = Composition("sleep")
    v = app.compute("sleep", "sleep", inputs=("x",), outputs=("out",))
    app.bind_input("x", v["x"])
    app.bind_output("out", v["out"])
    node = WorkerNode(reg, num_slots=2, comm_slots=1)  # one compute slot
    done = []
    node.invoke(app, {"x": [Item(b"")]}, on_done=done.append)
    node.run()
    billed_ms = 1e3 * done[0].latency
    ok = not done[0].failed and billed_ms >= 0.95 * device_ms
    log(f"[platform] billing: SM clock {clocks} -> {max_mhz * 1e3:.0f} cycles/ms at the maximum; "
        f"_sleep({cycles}) takes {device_ms:.3f} ms of device time (CUDA events) and returns to "
        f"the host in {launch_ms:.3f} ms; the node bills the payload {billed_ms:.3f} ms (need >= "
        f"0.95 x {device_ms:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the node billed a payload less than its device time")


def platform_serve(torch, cfg, api, params):
    """granite through ``serve_lm`` on a WorkerNode: the tokens must equal the
    payload's call sequence run on one batcher directly, the launch counts the
    expected ones. Returns the node run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import ContinuousBatcher, Request
    from repro_torch.serving.serve_lm import serve_on_node, tokens_of

    prompts = _platform_prompts(cfg)
    batcher = ContinuousBatcher(api, params, num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    node, runs = serve_on_node(batcher, prompts, PLATFORM_NEW, num_slots=4, comm_slots=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if any(r is None or r.failed for r in runs):
        raise AssertionError(f"serve_lm: a request did not complete: {runs}")
    got = [tokens_of(r) for r in runs]

    direct = ContinuousBatcher(api, params, num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE)
    want = []
    for rid, p in enumerate(prompts, start=1):
        direct.submit(Request(rid, p, max_new_tokens=PLATFORM_NEW))
        want.append(direct.run_to_completion()[rid])
    expected = expected_launches(cfg, len(prompts), batcher.steps)
    lat = node.latency.summary()
    log(f"[platform] serve_lm {cfg.name} on a WorkerNode (4 slots, 1 comm slot): {len(prompts)} "
        f"requests of {PLATFORM_NEW} new tokens, prompts {[len(p) for p in prompts]}, cache "
        f"{SERVE_CACHE}, {batcher.steps} decode steps; virtual latency (billed from the measured "
        f"executions) " + ", ".join(f"{k} {v:.3f}" for k, v in lat.items())
        + f"; per request {[round(r.latency * 1e3, 3) for r in runs]} ms; wall {wall:.3f} s; "
        f"committed avg {node.committed_avg_bytes / 2**20:.3f} MiB, peak "
        f"{node.committed_peak_bytes / 2**20:.3f} MiB, failed {node.failed_count}")
    for r, g in zip(runs, got):
        log(f"[platform] serve_lm request: {len(g)} tokens, first {g[:4]}")
    for name, n in expected.items():
        log(f"[platform] serve_lm launches {name}: {counts[name]} (expected {n})")
    ok = got == want and all(len(g) == PLATFORM_NEW for g in got) and node.failed_count == 0
    log(f"[platform] serve_lm tokens equal the batcher run directly: {got == want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("serve_lm through the node disagrees with the batcher run directly")
    if counts != expected:
        raise AssertionError(f"serve_lm: launch counts {counts} != expected {expected}")
    return counts


def _platform_prompts(cfg):
    """phase 5's requests: ``PLATFORM_REQUESTS`` prompts of 64-512 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
            for n in rng.integers(64, 513, size=PLATFORM_REQUESTS)]


def _sdk_serve(torch, what, cfg, batcher, app, prompts, platform, want, walls):
    """Serve ``prompts`` through ``serve_lm`` on ``platform`` with the launch
    counters set to 0 just before and read just after; check the tokens against
    ``want``, the counts against the expected ones and each request's virtual
    latency against its payload's measured wall. Returns the counts."""
    from repro_torch.kernels import ops
    from repro_torch.serving.serve_lm import serve_on_platform, tokens_of

    steps0 = batcher.steps
    walls.clear()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = serve_on_platform(batcher, prompts, PLATFORM_NEW, platform, app=app)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if not all(h.done for h in handles):
        raise AssertionError(f"sdk {what}: a request did not complete: "
                             f"{[h.failed for h in handles]}")
    got = [tokens_of(h) for h in handles]
    steps = batcher.steps - steps0
    expected = expected_launches(cfg, len(prompts), steps)
    lat = platform.latency.summary()
    log(f"[platform] sdk {what}: {len(prompts)} requests of {PLATFORM_NEW} new tokens, {steps} "
        f"decode steps; nodes {[n.name for n in platform.nodes]}; latency.summary() (virtual) "
        + ", ".join(f"{k} {v:.3f}" for k, v in lat.items())
        + f"; per request {[round(h.latency * 1e3, 3) for h in handles]} ms; payload walls "
        f"{[round(walls[tuple(p)] * 1e3, 3) for p in prompts]} ms; wall {wall:.3f} s")
    for name, n in expected.items():
        log(f"[platform] sdk {what} launches {name}: {counts[name]} (expected {n})")
    ok = got == want and all(len(g) == PLATFORM_NEW for g in got)
    log(f"[platform] sdk {what} tokens equal the batcher run directly: {got == want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"sdk {what}: serve_lm disagrees with the batcher run directly")
    if counts != expected:
        raise AssertionError(f"sdk {what}: launch counts {counts} != expected {expected}")
    short = [(round(h.latency, 6), round(walls[tuple(p)], 6)) for h, p in zip(handles, prompts)
             if h.latency < walls[tuple(p)]]
    if short:
        raise AssertionError(f"sdk {what}: virtual latency below the payload's wall: {short}")
    return counts


def platform_sdk(torch, cfg, api, params):
    """Dandelion's SDK front door on the card, on ``cfg``'s model: (a) ``serve_lm``
    declared through ``repro_torch.sdk`` on a one-node ``sdk.Platform``
    (examples/serve_lm.py's shape), (b) the same app object on an elastic
    cluster of 1-2 nodes (examples/quickstart.py's step 5), both under strict
    verification, each with tokens equal to the batcher run directly and exact
    launch counts; (c) the MLP as a ``torch_fn`` payload through
    ``sdk.function`` on a snapshot-backend node, against the eager payload; (d)
    ``sdk.verify`` lists ``generate`` as unsafe. Returns (a)'s and (b)'s counts."""
    from repro_torch import sdk
    from repro_torch.core import Item
    from repro_torch.serving.batching import ContinuousBatcher, Request
    from repro_torch.serving.serve_lm import serve_lm_sdk_app

    prompts = _platform_prompts(cfg)
    direct = ContinuousBatcher(api, params, num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE)
    want = []
    for rid, p in enumerate(prompts, start=1):
        direct.submit(Request(rid, p, max_new_tokens=PLATFORM_NEW))
        want.append(direct.run_to_completion()[rid])
    del direct

    # each payload's measured wall (the card synchronised), keyed by its prompt
    batcher = ContinuousBatcher(api, params, num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE)
    walls, last, submit, run = {}, [], batcher.submit, batcher.run_to_completion

    def timed_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls[tuple(last[-1])] = time.perf_counter() - t0
        return out

    def recorded_submit(req):
        last.append(req.prompt)
        submit(req)

    batcher.submit, batcher.run_to_completion = recorded_submit, timed_run
    app = serve_lm_sdk_app(batcher, PLATFORM_NEW)
    counts = [_sdk_serve(torch, "node", cfg, batcher, app, prompts, sdk.Platform(
        node=sdk.NodeSpec(num_slots=4, comm_slots=1), verify="strict"), want, walls)]
    elastic = sdk.Platform(elastic=sdk.Elastic(
        config=sdk.ControlPlaneConfig(min_nodes=1, max_nodes=2), node=sdk.NodeSpec(num_slots=4)),
        verify="strict")
    counts.append(_sdk_serve(torch, "elastic", cfg, batcher, app, prompts, elastic, want, walls))
    cp = elastic.control_plane
    log(f"[platform] sdk elastic: nodes booted {[n.name for n in elastic.nodes]}, node-count "
        f"timeline {[(round(t, 3), int(n)) for t, n in cp.node_count_timeline.points]}, routing "
        f"{cp.stats.summary()}")

    mlp, x = _mlp(torch)

    @sdk.function(inputs=("x",), outputs=("out",), torch_fn=mlp,
                  example_args=(torch.zeros_like(x),))
    def mlp_payload(ins):
        return {"out": [Item(mlp(torch.as_tensor(ins["x"][0].data, device="cuda")).cpu().numpy())]}

    snap = sdk.Platform(node=sdk.NodeSpec(num_slots=2, backend="snapshot"))
    mlp_app = sdk.single_function_app(mlp_payload)
    snap.deploy(mlp_app)
    h = snap.invoke(mlp_app, {"x": [Item(x.cpu().numpy())]})
    got = torch.as_tensor(h.result()["out"][0].data)
    want_mlp = mlp(x).cpu()
    err = (got - want_mlp).abs().max().item()
    ok = (got.shape == want_mlp.shape and err <= TOL["float32"]
          and snap.registry.get("mlp_payload").torch_fn is mlp)
    log(f"[platform] sdk torch_fn payload on a snapshot node: billed {h.latency * 1e3:.3f} ms; "
        f"output vs the eager payload max_abs_err {err:.3e} (tolerance {TOL['float32']}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("sdk.function's torch_fn payload disagrees on the snapshot backend")

    report = sdk.verify(app)
    log(f"[platform] sdk.verify(serve_lm): checked {list(report.checked)}, unsafe "
        f"{list(report.unsafe)}, {len(report.waived)} waived, {len(report.blocking)} blocking")
    if "generate" not in report.unsafe or report.blocking:
        raise AssertionError(f"sdk.verify: generate not listed as unsafe: {report}")
    return counts


def platform_calibration(torch, api, params):
    """``trace_capture`` at full width: CUDA-event step times, the affine fit,
    the calibrated ``BatchStepModel`` and its residuals (printed, not bounded).
    Returns the step timings (phase 7(c) holds them against the modeled roofline)."""
    from repro_torch.serving import trace_capture as tc

    timings = tc.capture_step_timings(api, params, batches=CALIBRATION_BATCHES,
                                      cache_len=SERVE_CACHE, prompt_len=256, samples=3)
    for t in timings:
        log(f"[platform] step timing batch {t.batch}: prefill {t.prefill_s * 1e3:.3f} ms, decode "
            f"{t.decode_s * 1e3:.3f} ms (median of 3, CUDA events)")
    fixed, per_seq = tc.fit_affine(timings)
    model = tc.calibrated_batch_model(timings)
    res = tc.calibration_residuals(timings, model)
    log(f"[platform] affine fit: fixed {fixed * 1e3:.4f} ms + {per_seq * 1e3:.4f} ms per sequence; "
        f"{model}; residuals " + ", ".join(f"batch {b}: {r:+.4f}" for b, r in res))
    return timings


def phase_platform(torch, cfg, api, params):
    """Dandelion's worker node and SDK on the card, after ``cfg``'s serving run on
    its model: Table 1, billing of queued device work, serve_lm through a
    WorkerNode and through ``sdk.Platform``, and the step calibration. Returns
    the launch counts of the serving runs and the calibration's step timings."""
    t0 = time.perf_counter()
    platform_table1(torch)
    platform_billing(torch)
    counts = [platform_serve(torch, cfg, api, params)]
    t1 = time.perf_counter()
    counts += platform_sdk(torch, cfg, api, params)
    log(f"[platform] platform_sdk {time.perf_counter() - t1:.1f} s")
    timings = platform_calibration(torch, api, params)
    log(f"[platform] {time.perf_counter() - t0:.1f} s")
    return counts, timings


# ---------------------------------------------------------------------------
# phase 6: training on the card
# ---------------------------------------------------------------------------
def train_kernel_rows(torch, timer: Timer):
    """(a) Each kernel's ``autograd.Function`` (the kernel forward, the gradient
    formula backward) against ``torch.autograd`` of its plain version on the card,
    forward and backward at the training shapes, in bf16 and float32, with device
    times beside the bound of the same work and the library's forward+backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import rmsnorm as krms

    gen = torch.Generator(device="cuda").manual_seed(6)
    has_gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    lib_rms = getattr(F, "rms_norm", None)

    def rnd(shape, dt, grad=True):
        t = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dt)
        return t.requires_grad_(grad)

    def fwd_bwd(f, inputs, g):
        """The output of ``f(*inputs)`` and the gradients of ``inputs`` for ``g``."""
        out = f(*inputs)
        return (out.detach(), *torch.autograd.grad(out, inputs, g))

    def record(name, case, make, labels, nbytes, flops, dtn):
        sets = [make() for _ in range(Timer.copies(nbytes))]
        kernel_fn, plain_fn, lib_fn = sets[0]
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        for label, g, w in zip(labels, got, want):
            _check(f"{name} fwd+bwd {case} {dtn} {label}", g, w, dtn)
        del got, want
        (k_ms, k_hb), (p_ms, p_hb) = (timer.ms([st[i] for st in sets]) for i in (0, 1))
        l_ms, l_hb = timer.ms([st[2] for st in sets]) if lib_fn is not None else (None, False)
        b_ms, b_by = bound_ms(nbytes, flops, dtn)
        flag = lambda hb: " (host-bound)" * hb
        log(f"[train] {name} fwd+bwd {case} {dtn}: kernel_ms {k_ms:.5f}{flag(k_hb)} plain_ms "
            f"{p_ms:.5f}{flag(p_hb)} library_ms "
            f"{('%.5f' % l_ms) + flag(l_hb) if l_ms is not None else 'null'} bound_ms {b_ms:.5f} "
            f"({b_by}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); share of bound "
            f"{b_ms / k_ms:.4f}{'' if l_ms is None else f', kernel/library {k_ms / l_ms:.2f}x'}")

    for dt, dtn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        size = torch.tensor([], dtype=dt).element_size()
        shape = TRAIN_RMS_SHAPE

        def make(dt=dt, shape=shape):
            x, s, g = rnd(shape, dt), rnd(shape[-1:], dt), rnd(shape, dt, grad=False)
            return (lambda: fwd_bwd(lambda a, b: krms.RMSNormFunction.apply(a, b, 1e-5), (x, s), g),
                    lambda: fwd_bwd(lambda a, b: krms.plain(a, b, 1e-5), (x, s), g),
                    (lambda: fwd_bwd(lambda a, b: lib_rms(a, (shape[-1],), b, 1e-5), (x, s), g))
                    if lib_rms else None)

        numel = int(np.prod(shape))
        # x and g read, y and dx written; scale read, dscale written. About 12 float32
        # operations an element (forward 4, backward 8)
        record("rmsnorm", str(list(shape)), make, ("y", "dx", "dscale"),
               (4 * numel + 2 * shape[-1]) * size, 12.0 * numel, dtn)

        for what, b, sq, sk, hq, hkv, dh, causal in TRAIN_FLASH_CASES:
            def make(b=b, sq=sq, sk=sk, hq=hq, hkv=hkv, dh=dh, causal=causal, dt=dt):
                q, k, v = rnd((b, sq, hq, dh), dt), rnd((b, sk, hkv, dh), dt), rnd((b, sk, hkv, dh), dt)
                g = rnd((b, sq, hq, dh), dt, grad=False)

                def lib(qt, kt, vt):
                    return F.scaled_dot_product_attention(
                        qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), is_causal=causal,
                        enable_gqa=True).transpose(1, 2)

                return (lambda: fwd_bwd(lambda *t: kfl.FlashAttentionFunction.apply(*t, causal, 0, None),
                                        (q, k, v), g),
                        lambda: fwd_bwd(lambda *t: kfl.plain(*t, causal=causal), (q, k, v), g),
                        (lambda: fwd_bwd(lib, (q, k, v), g)) if has_gqa else None)

            pairs = b * (sq * (sq + 1) // 2 if causal else sq * sk)
            # q, k, v and dO read, O, dQ, dK and dV written; QKᵀ and PV forward, dV, dP,
            # dQ and dK backward: 12·Hq·dh a query-key pair the mask allows
            record("flash_attention",
                   f"{what} q[{b},{sq},{hq},{dh}] kv[{b},{sk},{hkv},{dh}] "
                   f"{'causal' if causal else 'non-causal'}", make, ("o", "dq", "dk", "dv"),
                   2 * (2 * b * sq * hq + 2 * b * sk * hkv) * dh * size, 12.0 * hq * dh * pairs, dtn)
        gc.collect()
        torch.cuda.empty_cache()


def _loss_and_grads(torch, api, params, batch, remat):
    """(loss, {leaf path: gradient}) of ``api.train_loss`` on ``batch``."""
    from repro_torch.models.common import tree_items

    leaves = [t.requires_grad_(True) for _, t in tree_items(params)]
    loss = api.train_loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip((p for p, _ in tree_items(params)), grads))


def train_reference(torch):
    """(b) ``train_loss`` and every leaf's gradient of granite-8b (full width, 2 layers,
    seq 512, batch 2) and whisper-base (whole, 1500 frames, 384 tokens): the card in
    float32 (TF32 off) and bf16 under remat "full", through the kernels' autograd
    Functions, against the CPU's float32 plain run without remat, as the relative norm
    error of each leaf. olmoe-1b-7b and mamba2-130m (2 layers) must refuse autograd,
    naming ``moe_gmm`` and ``ssd``."""
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build
    from repro_torch.training.data import make_batch, to_device

    _no_tf32(torch)
    for arch, seq in (("granite-8b", 512), ("whisper-base", 384)):
        cfg = get_config(arch)
        if cfg.family != "encdec":
            cfg = cfg.replace(num_layers=2)
        gpu, cpu = build(cfg, device="cuda"), build(cfg, device="cpu")
        params = gpu.init_params(torch.Generator(device="cuda").manual_seed(0))
        batch = make_batch(cfg, ShapeConfig("reference", seq, 2, "train"), 0)
        t0 = time.perf_counter()
        want_loss, want = _loss_and_grads(
            torch, cpu, cast_params(params, cpu.param_template, "cpu", torch.float32),
            to_device(batch, "cpu", torch.float32), "none")
        log(f"[train] {arch} {cfg.num_layers}-layer full width, batch 2 x {seq}: CPU float32 loss "
            f"{want_loss.item():.6f} and {len(want)} gradients in {time.perf_counter() - t0:.1f} s")
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            loss, got = _loss_and_grads(torch, gpu, cast_params(params, gpu.param_template, "cuda", dt),
                                        to_device(batch, "cuda", dt), "full")
            errs = {path: ((g.float().cpu() - want[path]).norm() / want[path].norm()).item()
                    for path, g in got.items()}
            loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
            worst = max(errs, key=errs.get)
            ok = max(errs.values()) <= GRAD_TOL[dtn] and loss_err <= GRAD_TOL[dtn] and all(
                g.abs().max().item() > 0 for g in got.values())
            log(f"[train] {arch} card {dtn} (remat full) vs CPU float32: loss {loss.item():.6f} "
                f"(relative error {loss_err:.2e}); relative gradient norm error per leaf: max "
                f"{errs[worst]:.2e} ({worst}), median {float(np.median(list(errs.values()))):.2e} "
                f"over {len(errs)} leaves (need <= {GRAD_TOL[dtn]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{arch}: gradients on the card disagree with the CPU ({dtn})")
            del got
        del gpu, cpu, params, want
        gc.collect()
        torch.cuda.empty_cache()

    for arch, kernel in (("olmoe-1b-7b", "moe_gmm"), ("mamba2-130m", "ssd")):
        cfg = get_config(arch).replace(num_layers=2)
        api = build(cfg, device="cuda")
        params = api.init_params(torch.Generator(device="cuda").manual_seed(0))
        batch = to_device(make_batch(cfg, ShapeConfig("reference", 256, 2, "train"), 0), "cuda",
                          torch.bfloat16)
        try:
            _loss_and_grads(torch, api, params, batch, "full")
        except NotImplementedError as e:
            ok = str(e).startswith(f"{kernel}:")
            log(f"[train] {arch} under autograd on the card raises NotImplementedError: {e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{arch}: the refusal does not name {kernel}") from e
        else:
            raise AssertionError(f"{arch}: trained on the card, but {kernel} has no backward")
        del api, params
        gc.collect()
        torch.cuda.empty_cache()


def train_run(torch):
    """(c) granite-8b at full width, cut to the deepest whose training state fits
    ``TRAIN_BUDGET_BYTES`` (``serve_depth`` of the parameters that many bytes hold): bf16, seq 4096, global
    batch 8 in 4 micro-batches, remat "full", ``TRAIN_STEPS`` AdamW steps on one
    repeated batch (it must overfit: the last loss below the first, every grad norm
    finite), with exact launch counts (recompute included), then a profile of one
    step by kernel group. Returns the counts."""
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.config.shapes import TRAIN_4K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build
    from repro_torch.training.data import make_batch, to_device
    from repro_torch.training.train_step import build_train_step, init_train_state

    cfg = get_config(TRAIN_ARCH)
    depth = serve_depth(cfg, int(TRAIN_BUDGET_BYTES // TRAIN_BYTES_PER_PARAM))
    cfg = cfg.replace(num_layers=depth)
    api = build(cfg, device="cuda")
    plan = ParallelPlan(remat="full", grad_accum=TRAIN_ACCUM)
    n = api.param_count()
    log(f"[train] {TRAIN_ARCH}: depth cut from {get_config(TRAIN_ARCH).num_layers} to {depth} layers, "
        f"{n / 1e9:.3f} B params, {TRAIN_BYTES_PER_PARAM} bytes a parameter = "
        f"{n * TRAIN_BYTES_PER_PARAM / 1e9:.1f} GB (budget {TRAIN_BUDGET_BYTES / 1e9:.0f} GB)")
    state = init_train_state(api, torch.Generator(device="cuda").manual_seed(0), plan)
    step = build_train_step(api, plan, lr=TRAIN_LR, warmup_steps=2, total_steps=100)
    batch = to_device(make_batch(cfg, TRAIN_4K, 0, batch_override=TRAIN_BATCH), "cuda",
                      torch.bfloat16)
    tokens = TRAIN_BATCH * TRAIN_4K.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, norms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        share = 8 * n * tokens / (times[-1] * peak_flops("bfloat16"))
        log(f"[train] step {i}: loss {losses[-1]:.4f}, grad_norm {norms[-1]:.4f}, lr "
            f"{m['lr'].item():.3e}, {1e3 * times[-1]:.1f} ms, {tokens / times[-1]:.0f} tokens/s, "
            f"8·N·tokens / (time · 989 TFLOP/s) = {share:.4f}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts = ops.launch_counts()
    L = depth
    expected = {"rmsnorm": TRAIN_STEPS * TRAIN_ACCUM * (2 * L + 1 + 2 * L),
                "flash_attention": TRAIN_STEPS * TRAIN_ACCUM * 2 * L,
                "decode_attention": 0, "moe_gmm": 0, "ssd": 0}
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_4K.seq_len} tokens ({TRAIN_ACCUM} "
        f"micro-batches, remat full): median step after the first {1e3 * steady:.1f} ms = "
        f"{tokens / steady:.0f} tokens/s, share {8 * n * tokens / (steady * peak_flops('bfloat16')):.4f}; "
        f"first step {1e3 * times[0]:.1f} ms; loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("[train] launches (expected per micro-batch: 2L+1 norms forward and 2L recomputed, "
        "L attentions forward and L recomputed): " + ", ".join(
            f"{name} {counts[name]} (expected {c})" for name, c in expected.items()))
    if not all(math.isfinite(g) for g in norms) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not progress: losses {losses}, grad norms {norms}")
    if counts != expected:
        raise AssertionError(f"training: launch counts {counts} != expected {expected}")
    # where a step's device time goes (after the counts were read; two more steps)
    profile_breakdown(torch, f"{TRAIN_ARCH} ({depth} L) train step", 1, lambda: step(state, batch))
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_lm_resume(torch):
    """(d) ``train_lm`` (lm-100m, batch 8 x 128) on ``sdk.Platform`` under
    deterministic algorithms: phase 1 trains to step 20 and crashes, phase 2
    resumes from its checkpoint to step 40; its losses must equal an uninterrupted
    run's, and that run's last checkpoint must restore on the CPU into its state.
    Returns the launch counts of the three runs."""
    import os
    import tempfile

    from repro_torch import sdk
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.kernels import ops
    from repro_torch.models.model import build
    from repro_torch.training import train_lm
    from repro_torch.training.checkpoint import flatten_with_names, restore_checkpoint
    from repro_torch.training.train_step import abstract_train_state

    # cuBLAS needs a fixed workspace configuration for deterministic results
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    base = dict(steps=TRAIN_LM_STEPS, batch=8, seq=128, log_every=1, device="cuda")
    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        straight, crash = os.path.join(tmp, "straight"), os.path.join(tmp, "crash")
        torch.use_deterministic_algorithms(True)
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, want = train_lm.run(ckpt_dir=straight, **base)
            app = train_lm.train_app()
            platform = sdk.Platform(node=sdk.NodeSpec(num_slots=2, comm_slots=1))
            platform.deploy(app)
            first = train_lm.invoke_phase(platform, app, crash_at=TRAIN_LM_STEPS // 2,
                                          ckpt_dir=crash, **base)
            second = train_lm.invoke_phase(platform, app, ckpt_dir=crash, **base)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
        finally:
            torch.use_deterministic_algorithms(False)
        got = {int(k): v for r in (first, second) for k, v in r["losses"].items()}
        cfg = train_lm.hundred_m_config()
        L, runs = cfg.num_layers, 2 * TRAIN_LM_STEPS
        expected = {"rmsnorm": runs * (2 * L + 1), "flash_attention": runs * L,
                    "decode_attention": 0, "moe_gmm": 0, "ssd": 0}
        same = sum(got.get(k) == v for k, v in want.items())
        ok = (not first["completed"] and second["completed"] and got == want
              and counts == expected)
        log(f"[train] train_lm {cfg.name} on sdk.Platform, deterministic algorithms: crash at "
            f"step {TRAIN_LM_STEPS // 2}, resume to {TRAIN_LM_STEPS}: {same} of {len(want)} "
            f"losses equal the uninterrupted run's (max |diff| "
            f"{max(abs(got.get(k, math.inf) - v) for k, v in want.items()):.3e}); loss "
            f"{want[1]:.4f} -> {want[TRAIN_LM_STEPS]:.4f}; launches rmsnorm "
            f"{counts['rmsnorm']}, flash {counts['flash_attention']} (expected {expected['rmsnorm']}, "
            f"{expected['flash_attention']}); {wall:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train_lm: the resumed run differs: {got} != {want} or counts "
                                 f"{counts} != {expected}")

        api_cpu = build(cfg, device="cpu")
        restored, step = restore_checkpoint(straight, None, abstract_train_state(api_cpu, ParallelPlan()),
                                            device="cpu")
        pairs = list(zip(flatten_with_names(restored), flatten_with_names(state)))
        equal = step == TRAIN_LM_STEPS and all(
            a[0] == b[0] and a[1].dtype == b[1].dtype and torch.equal(a[1], b[1].cpu())
            for a, b in pairs)
        log(f"[train] train_lm's last checkpoint (step {step}) restored on the CPU: {len(pairs)} "
            f"leaves equal to the card's state: {equal} {'ok' if equal else 'FAIL'}")
        if not equal:
            raise AssertionError("train_lm: the checkpoint does not restore into the card's state")
    return counts


def phase_train(torch, timer: Timer):
    """Training on the card: (a) the kernels' gradients, (b) model gradients against
    the CPU, (c) a training run, (d) ``train_lm``'s crash and resume. Returns the
    launch counts of (c) and (d)."""
    t0 = time.perf_counter()
    train_kernel_rows(torch, timer)
    t1 = time.perf_counter()
    train_reference(torch)
    t2 = time.perf_counter()
    counts = [train_run(torch)]
    t3 = time.perf_counter()
    counts.append(train_lm_resume(torch))
    log(f"[train] (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, (d) "
        f"{time.perf_counter() - t3:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 7: the launch CLIs and the inference service on the card
# ---------------------------------------------------------------------------
def launch_serve(torch, arch: str, card: str):
    """(a) ``python -m repro_torch.launch.serve --arch <arch>``'s ``run`` at full width
    with the CLI's defaults, on weights from its seed: its tokens must equal the
    port's ``ContinuousBatcher`` run directly on the same weights, prompts and
    extras, and its launches ``expected_launches``. Returns the CLI run's counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import build
    from repro_torch.serving.batching import ContinuousBatcher, Request

    _no_tf32(torch)
    args = serve.parser().parse_args(["--arch", arch, "--device", "cuda"])
    cfg = get_config(arch)
    api = build(cfg, device="cuda")
    params = api.init_params(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    served = serve.run(args, params=params)
    counts = ops.launch_counts()

    extra = serve.request_extras(cfg, "cuda")
    direct = ContinuousBatcher(api, params, num_slots=args.slots,
                               cache_len=args.cache_len + cfg.num_patches,
                               extras_fn=lambda rid: extra)
    for rid, prompt in enumerate(serve.prompts(cfg, args)):
        direct.submit(Request(rid, prompt, max_new_tokens=args.max_new))
    want = direct.run_to_completion()
    expected = expected_launches(cfg, args.requests, direct.steps)
    tokens = sum(len(v) for v in served.results.values())
    same = sum(served.results.get(rid) == toks for rid, toks in want.items())
    extras = {k: tuple(v.shape) for k, v in extra.items()}
    ok = same == len(want) == args.requests and counts == expected
    log(f"[launch] serve {cfg.name}: {args.requests} requests, {args.slots} slots, cache "
        f"{args.cache_len}, {args.max_new} new tokens, extras {extras}: {same} of {len(want)} "
        f"requests' tokens equal the batcher's, {direct.steps} decode steps; launches " + ", ".join(
            f"{name} {counts[name]} (expected {n})" for name, n in expected.items())
        + f" {'ok' if ok else 'FAIL'}")
    log(f"[launch] serve {cfg.name}: served {len(served.results)} requests, {tokens} tokens in "
        f"{served.seconds:.2f}s ({tokens / served.seconds:.1f} tok/s) on {card}")
    if not ok:
        raise AssertionError(f"launch.serve {arch}: tokens {served.results} != {want} or counts "
                             f"{counts} != {expected}")
    del api, params, direct
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def launch_train(torch, card: str):
    """(b) ``python -m repro_torch.launch.train``'s ``run`` on whisper-base at full
    width (``LAUNCH_TRAIN_FLAGS``) under deterministic algorithms: an uninterrupted
    ``LAUNCH_TRAIN_STEPS[1]``-step run, then a run to ``LAUNCH_TRAIN_STEPS[0]`` and a
    restart to ``LAUNCH_TRAIN_STEPS[1]`` from its checkpoint; the restarted run's
    losses and grad norms must equal the uninterrupted run's bitwise. The step
    times are ``run``'s own. Returns the launch counts."""
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    crash_at, steps = LAUNCH_TRAIN_STEPS
    cfg = get_config(LAUNCH_TRAIN_ARCH)
    with tempfile.TemporaryDirectory(prefix="launch_train_") as tmp:
        args = lambda n, sub: train.parser().parse_args(
            ["--arch", LAUNCH_TRAIN_ARCH, *LAUNCH_TRAIN_FLAGS, "--steps", str(n),
             "--ckpt-dir", os.path.join(tmp, sub), "--device", "cuda"])
        torch.use_deterministic_algorithms(True)
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            walls = []
            for n, sub in ((steps, "straight"), (crash_at, "crash"), (steps, "crash")):
                t0 = time.perf_counter()
                walls.append((train.run(args(n, sub)), time.perf_counter() - t0))
            counts = ops.launch_counts()
        finally:
            torch.use_deterministic_algorithms(False)
    (straight_run, wall), (first_run, _), (second_run, resume_wall) = walls
    straight, first, second = straight_run.losses, first_run.losses, second_run.losses
    step_s = [straight_run.step_s[k] for k in sorted(straight_run.step_s)]
    tokens = int(LAUNCH_TRAIN_FLAGS[LAUNCH_TRAIN_FLAGS.index("--batch") + 1]) * int(
        LAUNCH_TRAIN_FLAGS[LAUNCH_TRAIN_FLAGS.index("--seq") + 1])
    steady = sorted(step_s[1:steps])[(steps - 1) // 2]   # the straight run's median after step 1
    runs = steps + crash_at + (steps - crash_at)
    per_step = cfg.encoder_layers + 2 * cfg.num_layers   # no remat in the encdec family
    expected = {"rmsnorm": 0, "flash_attention": runs * per_step, "decode_attention": 0,
                "moe_gmm": 0, "ssd": 0}
    resumed = {k: v for k, v in straight.items() if k > crash_at}
    resumed_norms = {k: v for k, v in straight_run.grad_norms.items() if k > crash_at}
    ok = (sorted(first) == list(range(1, crash_at + 1)) and second == resumed
          and second_run.grad_norms == resumed_norms
          and all(first[k] == straight[k] for k in first) and counts == expected
          and all(math.isfinite(v) for v in straight.values()))
    log(f"[launch] train {cfg.name} ({' '.join(LAUNCH_TRAIN_FLAGS)}), deterministic algorithms: "
        f"{steps} steps straight, {crash_at} then a restart to {steps}: "
        f"{sum(second.get(k) == v for k, v in resumed.items())} of {len(resumed)} resumed losses "
        f"equal the uninterrupted run's (and grad norms: "
        f"{second_run.grad_norms == resumed_norms}); loss {straight[1]:.4f} -> "
        f"{straight[steps]:.4f}, grad norm {straight_run.grad_norms[1]:.4f} -> "
        f"{straight_run.grad_norms[steps]:.4f}; "
        f"median step after the first {1e3 * steady:.1f} ms ({tokens / steady:.0f} tokens/s), "
        f"first {1e3 * step_s[0]:.1f} ms; walls {wall:.1f} s straight, {resume_wall:.1f} s the "
        f"restart (init or restore and checkpoints included); launches "
        f"flash {counts['flash_attention']} (expected {expected['flash_attention']}: "
        f"{per_step} a step), rmsnorm {counts['rmsnorm']} {'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        raise AssertionError(f"launch.train: the restarted run differs ({second} != {resumed}) or "
                             f"counts {counts} != {expected}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def launch_service(timings):
    """(c) ``apps.inference_service`` for granite-8b priced on ``H100_SXM``: the
    modeled prefill step, decode ``step_s(b)`` and weight cold start, beside phase
    5's CUDA-event decode steps; a measured step faster than its roofline term
    (``step_s(b)`` less ``overhead_s``) would mean wrong bytes or constants."""
    from repro_torch.apps.inference_service import lm_spec_from_config, register_inference_service
    from repro_torch.configs import get_config
    from repro_torch.core import FunctionRegistry

    spec = lm_spec_from_config(get_config(PLATFORM_ARCH))
    svc = register_inference_service(FunctionRegistry(), spec, hw=card_spec())
    m, wc = svc.batch_model, svc.weight_cold
    log(f"[launch] service {spec.name} on {card_spec().name}: {spec.param_bytes / 1e9:.3f} GB of "
        f"weights, {spec.kv_bytes_per_token} KV bytes a token; modeled prefill step "
        f"({spec.prompt_len_hint} tokens) {svc.prefill_step_s * 1e3:.4f} ms; weight cold start "
        f"{wc.total_s:.4f} s (load {wc.load_s:.4f} s + compile {wc.compile_s:.4f} s, "
        f"{wc.hlo_ops} ops)")
    bad = []
    for t in timings:
        roof = m.step_s(t.batch) - m.overhead_s
        log(f"[launch] service decode batch {t.batch}: modeled step_s {m.step_s(t.batch) * 1e3:.4f} "
            f"ms (roofline {roof * 1e3:.4f} + overhead {m.overhead_s * 1e3:.4f}); measured (phase 5, "
            f"CUDA events) {t.decode_s * 1e3:.4f} ms = {t.decode_s / roof:.3f}x the roofline")
        if t.decode_s < roof:
            bad.append(t.batch)
    if bad:
        raise AssertionError(f"measured decode steps at batches {bad} beat their H100_SXM roofline: "
                             "the LMSpec's bytes or the card's constants are wrong")


def phase_launch(torch, card: str, timings):
    """Phase 7: ``launch.serve`` (granite-8b and whisper-base), ``launch.train``
    (whisper-base, resumed bitwise) and the inference service on the card's
    constants. Returns the launch counts of the serve and train runs."""
    t0 = time.perf_counter()
    counts = [launch_serve(torch, arch, card) for arch in LAUNCH_SERVE_ARCHS]
    t1 = time.perf_counter()
    counts.append(launch_train(torch, card))
    t2 = time.perf_counter()
    launch_service(timings)
    log(f"[launch] (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    return counts


def _event_ms(torch, fn):
    """(fn's result, CUDA-event ms from before its first launch to after its last, host
    ms to the synchronise after it): the events see the host's gaps between launches."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def sharded_serve(torch, mesh, card: str):
    """(a) ``jit_serve_steps`` on granite-8b (bf16, full depth and width) against
    ``build_serve_steps`` on the same weights: a prefill of ``SHARDED_PROMPTS`` prompts,
    then ``SHARDED_DECODE`` decode steps, each decoding its own argmax; the logits and
    tokens must be equal bitwise and the sharded run's launch counts exact. Each decode
    step is timed with CUDA events, through DTensor and plain. Returns the counts."""
    import contextlib

    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build
    from repro_torch.serving.engine import build_serve_steps, jit_serve_steps
    from repro_torch.sharding.rules import gather, place_tree

    cfg = get_config(SHARDED_ARCH)
    api = build(cfg, device="cuda")
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(8)
    lens = rng.integers(64, 513, size=SHARDED_PROMPTS)
    tokens = torch.zeros((SHARDED_PROMPTS, SERVE_CACHE), dtype=torch.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n).astype(np.int32))
    tokens, plens = tokens.cuda(), torch.tensor(lens, dtype=torch.int32, device="cuda")
    plan = ParallelPlan().restrict_to(mesh.mesh_dim_names)
    plain = build_serve_steps(api)
    prefill, decode, (psh, _, _) = jit_serve_steps(api, plan, mesh, SHARDED_PROMPTS, SERVE_CACHE)
    dparams = place_tree(params, psh)

    def run(pf, dc, p, mode, steps):
        """(logits of the prefill and each step, tokens, event ms and host ms a step)."""
        with mode():
            logits, cache = pf(p, tokens, plens)
            outs, toks, ev, host = [gather(logits)], [], [], []
            tok = torch.argmax(outs[0], dim=-1).to(torch.int32)
            for _ in range(steps):
                (logits, tok, cache), e_ms, h_ms = _event_ms(torch, lambda: dc(p, cache, tok))
                tok = gather(tok)
                outs.append(gather(logits))
                toks.append(tok)
                ev.append(e_ms)
                host.append(h_ms)
        return outs, toks, ev, host

    sharded = lambda steps: run(prefill, decode, dparams, contextlib.nullcontext, steps)
    unsharded = lambda steps: run(plain.prefill, plain.decode, params, torch.inference_mode, steps)
    unsharded(2)          # warm-up: cuBLAS handles, DTensor's sharding propagation cache
    sharded(2)
    want, want_toks, p_ev, p_host = unsharded(SHARDED_DECODE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got, got_toks, s_ev, s_host = sharded(SHARDED_DECODE)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    L = cfg.num_layers
    expected = {"rmsnorm": (2 * L + 1) * (1 + SHARDED_DECODE), "flash_attention": L,
                "decode_attention": L * SHARDED_DECODE, "moe_gmm": 0, "ssd": 0}
    same_logits = sum(bool(torch.equal(g, w)) for g, w in zip(got, want))
    same_toks = sum(bool(torch.equal(g, w)) for g, w in zip(got_toks, want_toks))
    ok = same_logits == len(want) and same_toks == len(want_toks) and counts == expected
    log(f"[sharded] (a) serve {cfg.name} on a (1, 1) NCCL mesh, {SHARDED_PROMPTS} prompts of "
        f"{list(map(int, lens))} tokens in a {SERVE_CACHE} cache, {SHARDED_DECODE} decode steps: "
        f"logits bitwise equal {same_logits} of {len(want)}, tokens {same_toks} of "
        f"{len(want_toks)}; launches " + ", ".join(f"{k} {counts[k]} (expected {n})"
                                                   for k, n in expected.items()))
    log(f"[sharded] (a) decode step, median of {SHARDED_DECODE} (CUDA events / host to the "
        f"synchronise): DTensor {_median(s_ev):.2f} / {_median(s_host):.2f} ms, plain "
        f"{_median(p_ev):.2f} / {_median(p_host):.2f} ms; DTensor adds "
        f"{_median(s_ev) - _median(p_ev):.2f} ms a step ({_median(s_ev) / _median(p_ev):.2f}x) "
        f"{'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        raise AssertionError(f"sharded serve: {same_logits}/{len(want)} logits and {same_toks}/"
                             f"{len(want_toks)} tokens bitwise equal, counts {counts} != {expected}")
    del params, dparams, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def sharded_train(torch, mesh, card: str):
    """(b) ``jit_train_step`` with ZeRO-3 on granite-8b at full width cut to
    ``SHARDED_TRAIN_LAYERS`` layers (seq ``SHARDED_TRAIN_SEQ`` x batch ``SHARDED_TRAIN_BATCH``,
    remat "full") against ``build_train_step`` from the same initial state, under
    deterministic algorithms: each step's loss and grad norm and, after the last, every
    leaf of the parameters and moments bitwise equal; exact launch counts. (c)
    ``compress_psum`` over the mesh's process group on the gradient leaves of the
    trained state, against ``tree_compress_with_feedback``: the mean and the residual
    bitwise equal. Returns the sharded run's counts."""
    import os

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import build
    from repro_torch.sharding.rules import gather, place_tree
    from repro_torch.training import compress
    from repro_torch.training.data import make_batch, to_device
    from repro_torch.training.train_step import build_train_step, init_train_state, jit_train_step

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config(SHARDED_ARCH).replace(num_layers=SHARDED_TRAIN_LAYERS)
    api = build(cfg, device="cuda")
    plan = ParallelPlan(remat="full", zero3=True).restrict_to(mesh.mesh_dim_names)
    shape = ShapeConfig("sharded", seq_len=SHARDED_TRAIN_SEQ, global_batch=SHARDED_TRAIN_BATCH,
                        kind="train")
    batch = to_device(make_batch(cfg, shape, 0), "cuda", torch.bfloat16)
    kw = dict(lr=TRAIN_LR, warmup_steps=2, total_steps=100)
    init = lambda: init_train_state(api, torch.Generator(device="cuda").manual_seed(0), plan)
    fn, _, state_sh, batch_sh = jit_train_step(api, plan, mesh, batch, **kw)
    L = SHARDED_TRAIN_LAYERS
    expected = {"rmsnorm": SHARDED_TRAIN_STEPS * (4 * L + 1),
                "flash_attention": SHARDED_TRAIN_STEPS * 2 * L, "decode_attention": 0,
                "moe_gmm": 0, "ssd": 0}
    torch.use_deterministic_algorithms(True)
    try:
        def train(step):
            state, out = init(), []
            for _ in range(SHARDED_TRAIN_STEPS):
                (state, m), _, h_ms = _event_ms(torch, lambda: step(state, batch))
                out.append((gather(m["loss"]).item(), gather(m["grad_norm"]).item(), h_ms))
            return state, out

        plain_state, plain_out = train(build_train_step(api, plan, **kw))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        state, out = train(fn)
        counts = ops.launch_counts()
        leaves = lambda st: [x for tree in (st.params, st.opt.mu, st.opt.nu)
                             for _, x in tree_items(tree)]
        same = sum(bool(torch.equal(gather(a), b))
                   for a, b in zip(leaves(state), leaves(plain_state)))
        n_leaves = len(leaves(plain_state))
        emb = state.params["embed"]
        del plain_state
        gc.collect()
        metrics_equal = [a[:2] == b[:2] for a, b in zip(out, plain_out)]
        ok = all(metrics_equal) and same == n_leaves and counts == expected
        log(f"[sharded] (b) train {cfg.name} ({L} of {get_config(SHARDED_ARCH).num_layers} "
            f"layers, {api.param_count() / 1e9:.3f} B params) with ZeRO-3 on a (1, 1) NCCL mesh, "
            f"{SHARDED_TRAIN_BATCH} x {SHARDED_TRAIN_SEQ} tokens, remat full, deterministic: "
            f"loss and grad norm bitwise equal in {sum(metrics_equal)} of {SHARDED_TRAIN_STEPS} "
            f"steps (losses {[o[0] for o in out]}), leaves (params, mu, nu) bitwise equal {same} "
            f"of {n_leaves}; embed {tuple(emb.shape)} placed {tuple(emb.placements)}; step ms "
            f"(host, synchronised) DTensor {[round(o[2], 1) for o in out]}, plain "
            f"{[round(o[2], 1) for o in plain_out]}; launches " + ", ".join(
                f"{k} {counts[k]} (expected {n})" for k, n in expected.items())
            + f" {'ok' if ok else 'FAIL'} on {card}")
        if not ok:
            raise AssertionError(f"sharded train: metrics equal {metrics_equal}, {same} of "
                                 f"{n_leaves} leaves equal, counts {counts} != {expected}")

        # (c) the gradient leaves of the trained state, through the sharded loss
        params = state.params
        for _, p in tree_items(params):
            p.requires_grad_(True)
        with implicit_replication():
            loss = api.train_loss(params, place_tree(batch, batch_sh), remat=plan.remat)
            grads = torch.autograd.grad(loss, [p for _, p in tree_items(params)])
        grads = {path: g.to_local() for (path, _), g in zip(tree_items(params), grads)}
        del loss, state, params
        zeros = {k: torch.zeros(g.shape, dtype=torch.float32, device="cuda") for k, g in grads.items()}
        dq, res = compress.tree_compress_with_feedback(grads, compress.CompressedState(zeros))
        group = mesh.get_group("data")
        t0 = time.perf_counter()
        psum = {k: compress.compress_psum(g, zeros[k], group) for k, g in grads.items()}
        torch.cuda.synchronize()
        psum_ms = 1e3 * (time.perf_counter() - t0)
        same_mean = sum(bool(torch.equal(psum[k][0], dq[k])) for k in grads)
        same_res = sum(bool(torch.equal(psum[k][1], res.residual[k])) for k in grads)
        n_el = sum(g.numel() for g in grads.values())
        ok = same_mean == same_res == len(grads)
        log(f"[sharded] (c) compress_psum over the NCCL group on {len(grads)} gradient leaves "
            f"({n_el / 1e9:.3f} B elements, {psum_ms:.1f} ms): mean equal to "
            f"tree_compress_with_feedback's dequantized output in {same_mean} of {len(grads)}, "
            f"residual in {same_res} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("compress_psum differs from tree_compress_with_feedback")
    finally:
        torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_sharded(torch, card: str):
    """Phase 8: the sharded steps on a (1, 1) NCCL mesh (a world of one over an
    in-process store, torn down at the end); (d) is phase 7(b), whose ``launch.train``
    runs on its own (1, 1) mesh. Returns the launch counts of (a) and (b)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    try:
        log(f"[sharded] mesh {mesh}, backend {dist.get_backend()}")
        counts = [sharded_serve(torch, mesh, card), sharded_train(torch, mesh, card)]
    finally:
        if started:
            dist.destroy_process_group()
    log(f"[sharded] phase {time.perf_counter() - t0:.1f} s")
    return counts


def dryrun_grid(card: str) -> None:
    """(a) ``python -m repro_torch.launch.dryrun --arch all --shape all --mesh
    DRYRUN_MESH`` as a child process (one worker a core): no cell fails, the
    skipped cells are exactly those ``config.shapes.applicability`` skips; one line a
    cell with its bottleneck, counted FLOPs over ``model_flops`` and peak bytes a
    device beside the card's HBM."""
    import os
    import tempfile

    from repro_torch.config.parallel import H100_SXM
    from repro_torch.config.shapes import SHAPE_ORDER, SHAPES, applicability
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.dryrun import MESHES

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="dryrun-", dir=ROOT / "build") as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape", "all",
               "--mesh", DRYRUN_MESH, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
                              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        wall = time.perf_counter() - t0
        summary = [line for line in proc.stdout.splitlines() if line.startswith("dry-run done")]
        log(f"[dryrun] (a) {' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s (host), "
            f"{summary[-1] if summary else 'no summary'}")
        kinds = ["single", "multi"] if DRYRUN_MESH == "both" else [DRYRUN_MESH]
        bad = []
        for kind in kinds:
            mesh_name = MESHES[kind][0]
            for arch in ARCH_IDS:
                for shape in SHAPE_ORDER:
                    tag = f"{arch}_{shape}_{mesh_name}".replace(".", "p")
                    path = Path(out) / f"{tag}.json"
                    cell = json.loads(path.read_text()) if path.exists() else {"error": "missing"}
                    want_skip = applicability(get_config(arch), SHAPES[shape])
                    if "error" in cell or bool(want_skip) != ("skipped" in cell):
                        bad.append(f"{tag}: {cell.get('error', cell.get('skipped', 'ran'))}")
                        continue
                    if "skipped" in cell:
                        log(f"[dryrun] SKIP {tag}")
                        continue
                    r, mem = cell["roofline"], cell["memory"]
                    log(f"[dryrun] OK   {tag}: bottleneck {r['bottleneck']}, step "
                        f"{r['step_time_s']:.4e} s, flops/model_flops "
                        f"{cell['counted_over_model_flops']:.4f}, peak "
                        f"{mem['peak_bytes_per_device'] / 1e9:.3f} GB a device of "
                        f"{H100_SXM.hbm_bytes / 1e9:.0f} GB")
    if proc.returncode != 0 or bad:
        tail = "\n".join(proc.stdout.splitlines()[-20:] + proc.stderr.splitlines()[-20:])
        raise AssertionError(f"dry-run grid: exit {proc.returncode}, cells wrong: {bad}\n{tail}")


def dryrun_tie(torch, mesh, card: str):
    """(b) Phase 8(a)'s granite-8b prefill of ``SHARDED_PROMPTS`` prompts in a
    ``SERVE_CACHE`` cache and one decode step after it, counted twice: on ``meta``
    tensors through ``launch.dryrun.run_cell`` and live on the card under the same
    ``CostCounter``; FLOPs, bytes and per-kernel calls must be equal. Each step's
    roofline on ``H100_SXM`` beside its CUDA-event time, plain and through DTensor;
    a measured step faster than its roofline fails. Returns the live run's counts."""
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_counter import CostCounter
    from repro_torch.models.model import build
    from repro_torch.serving.engine import build_serve_steps, jit_serve_steps
    from repro_torch.sharding.rules import place, place_tree

    cfg = get_config(SHARDED_ARCH)
    shapes = {"prefill": ShapeConfig("prefill_1k", SERVE_CACHE, SHARDED_PROMPTS, "prefill"),
              "decode": ShapeConfig("decode_1k", SERVE_CACHE, SHARDED_PROMPTS, "decode")}
    cells = {k: dryrun.run_cell(cfg.name, s, mesh, "card_1x1", cfg=cfg) for k, s in shapes.items()}

    api = build(cfg, device="cuda")
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(8)
    lens = rng.integers(64, 513, size=SHARDED_PROMPTS)
    tokens = torch.zeros((SHARDED_PROMPTS, SERVE_CACHE), dtype=torch.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n).astype(np.int32))
    tokens, plens = tokens.cuda(), torch.tensor(lens, dtype=torch.int32, device="cuda")
    plan = dryrun.default_plan(shapes["decode"], mesh)
    prefill, decode, (psh, _, tsh) = jit_serve_steps(api, plan, mesh, SHARDED_PROMPTS, SERVE_CACHE)
    dparams, dtokens, dplens = place_tree(params, psh), place(tokens, tsh), place(plens, tsh)
    first = lambda logits: place(torch.argmax(logits, dim=-1).to(torch.int32), tsh)
    with torch.no_grad():   # warm-up: cuBLAS handles, DTensor's sharding propagation cache
        logits, cache = prefill(dparams, dtokens, dplens)
        decode(dparams, cache, first(logits))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with CostCounter() as live_prefill:
            logits, cache = prefill(dparams, dtokens, dplens)
        tok = first(logits)
        with CostCounter() as live_decode:
            decode(dparams, cache, tok)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    L = cfg.num_layers
    expected = {"rmsnorm": 2 * (2 * L + 1), "flash_attention": L, "decode_attention": L,
                "moe_gmm": 0, "ssd": 0}
    ok = counts == expected
    for kind, live in (("prefill", live_prefill.costs()), ("decode", live_decode.costs())):
        meta = cells[kind]["cost_corrected"]
        calls = {k: v["calls"] for k, v in meta["kernels"].items()}
        same = (meta["flops"] == live.flops and meta["hbm_bytes"] == live.hbm_bytes
                and calls == {k: v[0] for k, v in live.kernels.items()})
        ok = ok and same
        log(f"[dryrun] (b) {kind} {cfg.name} x{SHARDED_PROMPTS} in a {SERVE_CACHE} cache, (1, 1) "
            f"mesh: meta {meta['flops']:.6e} FLOPs {meta['hbm_bytes']:.6e} bytes {calls}; live "
            f"{live.flops:.6e} FLOPs {live.hbm_bytes:.6e} bytes "
            f"{ {k: v[0] for k, v in live.kernels.items()} }: {'equal' if same else 'DIFFER'}")
    log(f"[dryrun] (b) launches {counts} (expected {expected})")

    plain = build_serve_steps(api)
    timed = {}
    for mode, pf, dc, p, tk, pl, ctx in (
            ("plain", plain.prefill, plain.decode, params, tokens, plens, torch.inference_mode),
            ("DTensor", prefill, decode, dparams, dtokens, dplens, torch.no_grad)):
        pre, dec = [], []
        with ctx():
            for _ in range(DRYRUN_REPEATS):
                (logits, cache), ms, _ = _event_ms(torch, lambda: pf(p, tk, pl))
                pre.append(ms)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                tok = place(tok, tsh) if mode == "DTensor" else tok
                _, ms, _ = _event_ms(torch, lambda: dc(p, cache, tok))
                dec.append(ms)
        timed[mode] = {"prefill": _median(pre), "decode": _median(dec)}
    for kind in ("prefill", "decode"):
        r = cells[kind]["roofline"]
        roof_ms = 1e3 * r["step_time_s"]
        for mode in ("plain", "DTensor"):
            ms = timed[mode][kind]
            ok = ok and ms >= roof_ms
            log(f"[dryrun] (b) {kind} step {mode}: {ms:.3f} ms (CUDA events, median of "
                f"{DRYRUN_REPEATS}) against its H100_SXM roofline {roof_ms:.3f} ms "
                f"({r['bottleneck']}), {ms / roof_ms:.2f}x {'ok' if ms >= roof_ms else 'FAIL'} "
                f"on {card}")
    if not ok:
        raise AssertionError(f"dry-run tie: counts or times disagree (launches {counts})")
    del params, dparams, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_dryrun(torch, card: str):
    """Phase 9: (a) the dry-run's grid as a child process, (b) its count of granite-8b's
    serve steps held against the same count live on the card, on a (1, 1) NCCL mesh
    (a world of one, torn down at the end). Returns (b)'s launch counts."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    dryrun_grid(card)
    log(f"[dryrun] (a) {time.perf_counter() - t0:.1f} s")
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    try:
        counts = dryrun_tie(torch, mesh, card)
    finally:
        if started:
            dist.destroy_process_group()
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s")
    return [counts]


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
        arch_counts, model = phase_serve(torch, arch, timer)
        runs = [arch_counts]
        if arch == PLATFORM_ARCH:  # the platform phase serves the same model and weights
            platform_counts, timings = phase_platform(torch, *model)
            runs += platform_counts
        for run in runs:
            for name, n in run.items():
                counts[name] = counts.get(name, 0) + n
        del model
        gc.collect()  # free one model before the next is built
        torch.cuda.empty_cache()
    phase_reference(torch)
    for run in (phase_train(torch, timer) + phase_launch(torch, card, timings)
                + phase_sharded(torch, card) + phase_dryrun(torch, card)):
        for name, n in run.items():
            counts[name] = counts.get(name, 0) + n
    for k in kernels:
        k["launches"] = counts[k["name"]]
    log(f"[done] {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
