"""The port's step calibration (``repro_torch.serving.trace_capture``) and
run configuration (``repro_torch.config.parallel``) against the reference's.

The fits are arithmetic on the timings, so on the same ``StepTiming``
lists both packages must give the same fit, step prices and residuals
exactly. The capture itself runs granite-8b smoke on the CPU (host-clock
times; on a card it times with CUDA events).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import parallel as ref_parallel  # noqa: E402
from repro.serving import trace_capture as ref_tc  # noqa: E402
from repro_torch.config import parallel  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import trace_capture as tc  # noqa: E402

TIMINGS = {
    "one_batch": [(4, 0.0121, 0.00433)],
    "affine": [(1, 0.010, 0.0050), (2, 0.011, 0.0061), (4, 0.013, 0.0083)],
    "noisy": [(1, 0.0301, 0.01113), (2, 0.0297, 0.01187), (4, 0.0335, 0.01059),
              (8, 0.0410, 0.01502)],
    "negative_fit": [(1, 0.02, 0.009), (2, 0.02, 0.004), (4, 0.02, 0.001)],
}


def _timings(mod, rows):
    return [mod.StepTiming(batch=b, prefill_s=p, decode_s=d) for b, p, d in rows]


@pytest.mark.parametrize("case", sorted(TIMINGS))
def test_fits_equal_the_reference(case):
    ref, port = _timings(ref_tc, TIMINGS[case]), _timings(tc, TIMINGS[case])
    assert tc.fit_affine(port) == ref_tc.fit_affine(ref)
    ref_model, model = ref_tc.calibrated_batch_model(ref), tc.calibrated_batch_model(port)
    assert dataclasses.asdict(model) == dataclasses.asdict(ref_model)
    batches = [0, 1, 2, 3, 4, 8, 16, 64]
    assert np.array_equal(model.step_s_batch(batches), ref_model.step_s_batch(batches))
    assert [model.step_s(b) for b in batches] == [ref_model.step_s(b) for b in batches]
    assert tc.calibration_residuals(port, model) == ref_tc.calibration_residuals(ref, ref_model)
    bw = 3.35e12
    assert dataclasses.asdict(tc.calibrated_batch_model(port, reference_bw=bw)) == \
        dataclasses.asdict(ref_tc.calibrated_batch_model(ref, reference_bw=bw))


def test_fits_refuse_no_timings():
    with pytest.raises(ValueError):
        tc.fit_affine([])
    with pytest.raises(ValueError):
        tc.calibration_residuals([], tc.calibrated_batch_model(_timings(tc, TIMINGS["affine"])))


def test_capture_on_granite_smoke():
    api = build(get_smoke("granite-8b"), device="cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    timings = tc.capture_step_timings(api, params, batches=(1, 2), cache_len=16, prompt_len=6,
                                      samples=3)
    assert [t.batch for t in timings] == [1, 2]
    assert all(t.prefill_s > 0 and t.decode_s > 0 for t in timings)
    model = tc.calibrated_batch_model(timings)
    res = tc.calibration_residuals(timings, model)
    assert [b for b, _ in res] == [1, 2] and all(np.isfinite(r) for _, r in res)


def test_h100_constants_are_the_data_sheets():
    h = parallel.H100_SXM
    assert (h.name, h.peak_flops, h.peak_flops_f32, h.hbm_bandwidth, h.hbm_bytes,
            h.ici_bandwidth, h.sm_count, h.l2_bytes, h.smem_bytes_per_sm, h.power_w) == \
        ("h100-sxm", 989e12, 67e12, 3.35e12, 80 * 10**9, 900e9, 132, 50 * 10**6, 228 * 1024,
         700.0)
    assert h == parallel.HardwareSpec()
    assert not hasattr(parallel, "TPU_V5E")
    # the fields the reference's cost models read are all there
    ref_fields = {f.name for f in dataclasses.fields(ref_parallel.HardwareSpec)}
    assert ref_fields - {f.name for f in dataclasses.fields(parallel.HardwareSpec)} == \
        {"vmem_bytes"}


def test_decode_kernel_plans_for_the_h100s_sms():
    from repro_torch.kernels import decode_attention

    assert decode_attention.SMS == parallel.H100_SXM.sm_count == 132


@pytest.mark.parametrize("axes", [("pod", "data", "model"), ("data", "model"), ("model",), ()])
def test_parallel_plan_restrict_to_equals_the_reference(axes):
    kw = dict(data_axes=("pod", "data"), fsdp_axes=("data",), tensor_axes=("model",),
              expert_axes=("model", "data"), seq_axes=("pod",), remat="dots", grad_accum=4,
              zero3=False, compress_grads=True, overlap_weight_gather=True)
    for plan_kw in ({}, kw):
        got = parallel.ParallelPlan(**plan_kw).restrict_to(axes)
        want = ref_parallel.ParallelPlan(**plan_kw).restrict_to(axes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
