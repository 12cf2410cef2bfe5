"""The port's cold-start backends (``repro_torch.core.coldstart``) on torch
payloads, on the CPU.

The cases of tests/test_coldstart.py, with the payload a torch function:
snapshot is a ``torch.export`` save/load round trip, microvm a fresh
``torch.compile`` (Inductor emits C++ here). Then each backend's output
against the eager payload, the MLP against the JAX package's payload on
the same weights, an integer matmul against the reference's backends, and
the failures that must raise. The first ``torch.compile`` of a process
pays Inductor's start-up, so microvm boots are few here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro_torch.core import FunctionRegistry, Item, cold_start, measure  # noqa: E402
from repro_torch.core import coldstart  # noqa: E402

F32_TOL = 2e-3  # tests/test_kernels.py::_tol, float32
L, D = 8, 64


@pytest.fixture(autouse=True)
def _one_compile_thread():
    """Inductor compiles in one process here (the tests share the host)."""
    with torch._inductor.config.patch(compile_threads=1):
        yield


def _registry_with_matmul(n=32):
    reg = FunctionRegistry()

    def fn(inputs):
        x = inputs["x"][0].data
        return {"out": [Item(np.asarray(x) @ np.asarray(x))]}

    reg.register_function("matmul", fn, torch_fn=lambda x: x @ x,
                          example_args=(torch.zeros((n, n), dtype=torch.int32),))
    return reg, {"x": [Item(np.ones((n, n), np.int32))]}


def _mlp_weights():
    return np.random.default_rng(0).normal(0.0, 0.2, size=(L, D, D)).astype(np.float32)


def _mlp_input():
    return np.random.default_rng(1).normal(size=(4, D)).astype(np.float32)


def _registry_with_mlp():
    """The 8-layer, width-64 tanh MLP of tests/test_coldstart.py, with the
    eager payload as the dandelion body."""
    ws = torch.from_numpy(_mlp_weights())

    def payload(x):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return x

    reg = FunctionRegistry()
    reg.register_function(
        "mlp", lambda ins: {"out": [Item(payload(torch.as_tensor(ins["x"][0].data)).numpy())]},
        torch_fn=payload, example_args=(torch.zeros((4, D), dtype=torch.float32),))
    return reg, {"x": [Item(_mlp_input())]}, payload


def _run(reg, name, inputs, backend):
    ctx, bd, run = cold_start(reg, name, inputs, backend=backend, device="cpu")
    out = run()["out"]
    ctx.free()
    return [it.data for it in out]


def test_dandelion_backend_runs_and_times():
    reg, inputs = _registry_with_matmul()
    bd, exec_s = measure(reg, "matmul", inputs, backend="dandelion", samples=3, device="cpu")
    assert bd.total > 0 and exec_s > 0
    # Dandelion's whole point: context bind is micro/sub-millisecond scale
    assert bd.total < 50e-3


def test_backend_ordering_dandelion_fastest():
    """dandelion is >=10x cheaper than either AOT-restore backend."""
    reg, inputs = _registry_with_matmul()
    d, _ = measure(reg, "matmul", inputs, backend="dandelion", samples=3, device="cpu")
    s, _ = measure(reg, "matmul", inputs, backend="snapshot", samples=3, device="cpu")
    m, _ = measure(reg, "matmul", inputs, backend="microvm", samples=3, device="cpu")
    assert d.total * 10 < min(s.total, m.total), (d.total, s.total, m.total)


def test_backend_ordering_full_with_real_program():
    """With a realistically sized program (the MLP), the full ordering
    dandelion << snapshot << microvm holds: compile dominates restore."""
    reg, inputs, _ = _registry_with_mlp()
    d_, _ = measure(reg, "mlp", inputs, backend="dandelion", samples=3, device="cpu")
    s_, _ = measure(reg, "mlp", inputs, backend="snapshot", samples=3, device="cpu")
    m_, _ = measure(reg, "mlp", inputs, backend="microvm", samples=3, device="cpu")
    assert d_.total < s_.total < m_.total, (d_.total, s_.total, m_.total)
    assert m_.total / d_.total > 10


def test_cache_miss_slower_than_hit():
    reg, inputs = _registry_with_matmul()
    hit, _ = measure(reg, "matmul", inputs, backend="dandelion", cached=True, samples=5,
                     device="cpu")
    miss_samples = []
    for _ in range(5):
        reg.evict("matmul")
        bd, _ = measure(reg, "matmul", inputs, backend="dandelion", cached=False, samples=1,
                        device="cpu")
        miss_samples.append(bd.load)
    assert np.median(miss_samples) >= hit.load * 0.5  # disk path not faster


def test_backends_give_the_eager_payloads_output():
    reg, inputs, payload = _registry_with_mlp()
    want = payload(torch.from_numpy(_mlp_input())).numpy()
    for backend in coldstart.BACKENDS:
        (got,) = _run(reg, "mlp", inputs, backend)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL, err_msg=backend)


def test_mlp_equals_the_jax_payload():
    """The port's MLP through the snapshot backend against the JAX package's
    scanned payload on the same numpy weights and input."""
    ws = jnp.asarray(_mlp_weights())

    def jax_payload(x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        out, _ = jax.lax.scan(body, x, ws)
        return out

    want = np.asarray(jax_payload(jnp.asarray(_mlp_input())))
    reg, inputs, _ = _registry_with_mlp()
    (got,) = _run(reg, "mlp", inputs, "snapshot")
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_integer_matmul_equals_the_reference():
    """int32 on the CPU (CUDA has no integer matmul): every port backend
    against the reference's AOT backends, exactly."""
    n = 32
    x = np.random.default_rng(2).integers(-50, 50, size=(n, n)).astype(np.int32)
    ref = ref_core.FunctionRegistry()
    ref.register_function("matmul", lambda ins: {"out": [Item(ins["x"][0].data @ ins["x"][0].data)]},
                          jax_fn=lambda a: a @ a,
                          abstract_args=(jnp.zeros((n, n), jnp.int32),))
    ref_inputs = {"x": [ref_core.Item(x)]}
    want = []
    for backend in ("snapshot", "microvm"):
        ctx, _, run = ref_core.cold_start(ref, "matmul", ref_inputs, backend=backend)
        want.append(run()["out"][0].data)
        ctx.free()
    assert np.array_equal(want[0], want[1]) and want[0].dtype == np.int32
    reg, _ = _registry_with_matmul(n)
    for backend in coldstart.BACKENDS:
        (got,) = _run(reg, "matmul", {"x": [Item(x)]}, backend)
        assert got.dtype == np.int32 and np.array_equal(got, want[0]), backend


def _data_dependent(x):
    if x.sum() > 0:  # a branch on a value: neither exportable nor one graph
        return x + 1
    return x - 1


@pytest.mark.parametrize("backend", ["snapshot", "microvm"])
def test_failed_export_or_compile_raises(backend):
    reg = FunctionRegistry()
    reg.register_function("bad", lambda ins: {"out": list(ins["x"])}, torch_fn=_data_dependent,
                          example_args=(torch.ones(3),))
    with pytest.raises(Exception) as exc:
        cold_start(reg, "bad", {"x": [Item(np.ones(3, np.float32))]}, backend=backend,
                   device="cpu")
    assert not isinstance(exc.value, (AssertionError, ValueError))


@pytest.mark.parametrize("backend", ["snapshot", "microvm"])
def test_aot_backends_refuse_a_missing_card_and_a_missing_payload(backend, monkeypatch):
    reg, inputs = _registry_with_matmul(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cold_start(reg, "matmul", inputs, backend=backend, device="cuda")
    reg.register_function("plain", lambda ins: ins)
    with pytest.raises(ValueError, match="torch payload"):
        cold_start(reg, "plain", inputs, backend=backend, device="cpu")


def test_sync_device_is_a_no_op_without_cuda():
    assert not torch.cuda.is_initialized()
    coldstart.sync_device()
