"""The frozen cost arithmetic against hand-worked values, the kernel calls the traced
run records, and the readers that divide them by device time."""
import pytest
import torch

from perfbench import costs
from perfbench.harness import Record, reader_for
from perfbench.tracing import DeviceTrace, KernelCalls


def test_causal_and_windowed_pairs():
    assert costs.causal_pairs(4) == 10
    assert costs.allowed_pairs(4, 4, True, 0) == 10
    assert costs.allowed_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert costs.allowed_pairs(3, 5, False, 0) == 15


def test_decode_counts_the_valid_slots_only():
    c = costs.decode_attention(2, 8, 4, 2, 4, 2, 2, valid=5, rows_without=1)
    assert c.bytes == (2 * 5 + 8 * 1) * 2 * 4 * 2 + 2 * 4 * 4 * (2 + 2) + (2 * 8 + 2) * 4
    assert c.flops == 4 * 4 * 4 * 5 + 2 * 4 * 8 * 1


def test_moe_gmm_counts_the_live_rows_and_experts():
    c = costs.moe_gmm(3, 4, 2, 5, 2, rows=5, experts=2)
    assert (c.flops, c.bytes) == (2 * 5 * 2 * 5, (5 * 2 + 2 * 2 * 5 + 3 * 4 * 5) * 2)
    b = costs.moe_gmm_backward(3, 4, 2, 5, 2, rows=5, experts=2)
    assert (b.flops, b.bytes) == (4 * 5 * 2 * 5, (5 * 7 + 2 * 10 + 3 * 4 * 2 + 3 * 10) * 2)


def test_model_flops_by_hand():
    cfg = dict(hidden_size=4, head_dim=2, num_attention_heads=2, num_key_value_heads=1,
               intermediate_size=3, num_hidden_layers=2, vocab_size=10)
    attn = 4 * 4 + 2 * 4 * 2 + 4 * 4
    n = 2 * (attn + 3 * 4 * 3) + 4 * 10
    assert costs.matmul_params(cfg) == n
    per_pair = 4 * 2 * 2 * 2
    assert costs.train_flops(cfg, 3, 5) == 6 * n * 15 + 3 * per_pair * 3 * 15
    assert costs.prefill_flops(cfg, 5) == 2 * (n - 40) * 5 + 2 * 40 + per_pair * 15
    assert costs.decode_flops(cfg, 7) == 2 * n + per_pair * 7
    moe = dict(cfg, num_experts=4, num_experts_per_tok=2)
    assert costs.matmul_params(moe) == 2 * (attn + 4 * 4 + 2 * 3 * 4 * 3) + 40


def test_recorded_calls_take_their_counts_from_the_inputs(cpu_threads):
    from repro_torch.kernels import ops
    calls = KernelCalls()
    calls.install()
    try:
        q = torch.randn(2, 4, 8)
        kc, vc = torch.randn(2, 6, 2, 8), torch.randn(2, 6, 2, 8)
        sp = torch.tensor([[0, 1, 2, -1, -1, -1], [-1, -1, -1, -1, -1, -1]], dtype=torch.int32)
        pos = torch.tensor([2, 0], dtype=torch.int32)
        ops.decode_attention(q, kc, vc, sp, pos)
        xe, we = torch.randn(3, 4, 2), torch.randn(3, 2, 5)
        ops.moe_gmm(xe, we, torch.tensor([[2], [3], [0]], dtype=torch.int32))
        ops.rmsnorm(torch.randn(3, 8), torch.ones(8))
    finally:
        calls.remove()
    got = calls.costs()
    assert got["decode_attention"] == [costs.decode_attention(2, 6, 4, 2, 8, 4, 4, valid=3,
                                                              rows_without=1)]
    assert got["moe_gmm"] == [costs.moe_gmm(3, 4, 2, 5, 4, rows=5, experts=2)]
    assert got["rmsnorm"] == [costs.rmsnorm(24, 8, 4)]
    assert ops.decode_attention.__name__ == "decode_attention"   # removed again


def _trace():
    # rmsnorm 10 ms, a cuBLAS product 20 ms overlapping it by 5, idle 65 of 100 ms
    ms = 1_000_000
    return DeviceTrace(0, 100 * ms, [("void rmsnorm_kernel<bf16>", 10 * ms, 20 * ms),
                                     ("nvjet_gemm", 15 * ms, 35 * ms)],
                       [("aten::mm", 40 * ms, 90 * ms), ("aten::copy_", 60 * ms, 70 * ms)])


def test_roofline_and_idle_readers():
    rec = Record({}, {}, kernel_costs={"rmsnorm": [costs.Cost(4e12, 1e9)]}, device=_trace())
    roof = reader_for("rmsnorm_roofline.serve")
    assert roof("rmsnorm_roofline.serve", rec) == pytest.approx(100 * (4e12 / 989e12) / 0.010)
    assert roof("flash_attention_roofline.serve", rec) is None     # no call: nothing
    idle = reader_for("device_idle_share.serve")
    assert idle("device_idle_share.serve", rec) == pytest.approx(75.0)
    tr = _trace()
    assert tr.busy_s() == pytest.approx(0.025)
    assert tr.idle_gaps()[0] == ["aten::copy_", pytest.approx(0.065)]
    assert tr.kernel_seconds() == {"rmsnorm": pytest.approx(0.010)}


def test_span_readers():
    rec = Record({}, {}, spans={"prefill": [(0.0, 0.1), (1.0, 1.3)], "decode_step": []},
                 span_window=(0.0, 2.0),
                 counters={"prefill_positions": 200, "prefill_prompt_tokens": 50,
                           "queue_waits": [0.1] * 9 + [1.1], "prefill_flops": 1e12,
                           "decode_flops": 1e12})
    assert reader_for("prefill_ms.serve")("prefill_ms.serve", rec) == pytest.approx(200.0)
    assert reader_for("decode_step_ms.serve")("decode_step_ms.serve", rec) is None
    assert reader_for("prefill_useful_share.serve")("prefill_useful_share.serve", rec) == 25.0
    assert reader_for("queue_wait_p90_ms.serve")("queue_wait_p90_ms.serve", rec) == pytest.approx(200.0)
    mfu = reader_for("mfu.serve")
    assert mfu("mfu.serve", rec) == pytest.approx(100 * 1e12 / (0.4 * 989e12))
    assert mfu("mfu.batch", rec) == pytest.approx(100 * 2e12 / (2.0 * 989e12))
