# det-lint: file waive[wall-clock] reason=real-exec calibration capture; measures actual step times to fit the modeled BatchStepModel
"""Trace capture: measure real prefill/decode step timings to calibrate
the platform's serving cost models.

Counterpart of ``repro.serving.trace_capture``, with the same fits. It
drives the port's real serving steps (``api.prefill`` / ``api.decode_step``,
eagerly), records step times per batch size, and fits them to the
platform's ``core.workloads.BatchStepModel`` shape — ``step_s(n) = fixed
+ n * per_seq`` (the decode step is memory-bound, so the affine fit is the
right functional form):

    timings = capture_step_timings(api, params, batches=(1, 2, 4))
    model = calibrated_batch_model(timings)

On a CUDA model each step is timed by a pair of CUDA events around it (the
device's view of the step, host gaps between its launches included); on a
CPU model by the host clock. The first call at each shape is the warm-up
(cuBLAS handles, the allocator, the kernels' first load), as the
reference's compile call is. Times are machine-dependent by construction:
nothing in a deterministic simulation path calls this module.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.workloads import BatchStepModel
from repro_torch.models.model import ModelApi


@dataclass(frozen=True)
class StepTiming:
    """Median seconds for one prefill + one decode step at a given batch
    size (post-warmup)."""

    batch: int
    prefill_s: float
    decode_s: float


def _timed(fn: Callable, cuda: bool):
    """(fn(), seconds): CUDA events around the call on the card, the host
    clock on the CPU."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def capture_step_timings(
    api: ModelApi,
    params,
    *,
    batches: Sequence[int] = (1, 2, 4),
    cache_len: int = 32,
    prompt_len: int = 8,
    samples: int = 3,
    seed: int = 0,
) -> List[StepTiming]:
    """Run the real steps per batch size and record medians of ``samples``.

    One warm-up call per (shape, step) comes before timing, so the medians
    measure steady-state step latency — the quantity the
    ``BatchStepModel`` roofline predicts."""
    dev = api.device
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    out: List[StepTiming] = []
    for b in batches:
        toks = torch.as_tensor(rng.integers(1, 100, size=(b, cache_len)), dtype=torch.int32,
                               device=dev)
        plens = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
        logits, cache = api.prefill(params, toks, plens)                # warm-up
        step_toks = torch.argmax(logits, dim=-1).to(torch.int32)
        api.decode_step(params, cache, step_toks)                       # warm-up

        pf, dc = [], []
        for _ in range(samples):
            (logits, cache), s = _timed(lambda: api.prefill(params, toks, plens), cuda)
            pf.append(s)
            (logits, cache), s = _timed(lambda: api.decode_step(params, cache, step_toks), cuda)
            dc.append(s)
        out.append(StepTiming(
            batch=int(b),
            prefill_s=float(np.median(pf)),
            decode_s=float(np.median(dc)),
        ))
    return out


def fit_affine(timings: Sequence[StepTiming]) -> Tuple[float, float]:
    """Least-squares ``decode_s ~ fixed + batch * per_seq`` fit. With a
    single batch size the whole cost is attributed to the fixed term
    (per_seq = 0) — enough for a smoke check, not a calibration."""
    if not timings:
        raise ValueError("no timings to fit")
    if len(timings) == 1:
        return timings[0].decode_s, 0.0
    xs = np.asarray([t.batch for t in timings], np.float64)
    ys = np.asarray([t.decode_s for t in timings], np.float64)
    per_seq, fixed = np.polyfit(xs, ys, 1)
    return float(max(fixed, 0.0)), float(max(per_seq, 0.0))


def calibrated_batch_model(
    timings: Sequence[StepTiming],
    *,
    reference_bw: float = 1.0,
) -> BatchStepModel:
    """Calibrated ``BatchStepModel``: the affine fit is encoded as a
    pure memory-roofline model (``fixed_bytes/hbm_bw = fixed``,
    ``bytes_per_seq/hbm_bw = per_seq``) with the compute term zeroed, so
    ``step_s(n)`` reproduces the measured affine curve exactly."""
    fixed_s, per_seq_s = fit_affine(timings)
    return BatchStepModel(
        flops_per_seq=0.0,
        fixed_bytes=fixed_s * reference_bw,
        bytes_per_seq=per_seq_s * reference_bw,
        peak_flops=1.0,
        hbm_bw=reference_bw,
        overhead_s=0.0,
    )


def calibration_residuals(
    timings: Sequence[StepTiming],
    model: BatchStepModel,
) -> List[Tuple[int, float]]:
    """Per-batch relative error of ``model`` against measured decode
    times: ``(batch, (predicted - measured) / measured)``. Prices every
    batch size in one vectorized ``step_s_batch`` call — the same path
    the batch engine uses — so a calibration report also exercises the
    code it certifies. Large residuals mean the affine form no longer
    fits (e.g. the real steps went compute-bound): recapture with more
    batch sizes before trusting what-if runs."""
    if not timings:
        raise ValueError("no timings to score")
    predicted = model.step_s_batch([t.batch for t in timings])
    return [
        (t.batch, float((p - t.decode_s) / t.decode_s))
        for t, p in zip(timings, predicted)
    ]
