"""The port's training substrate against the JAX package's: the AdamW update
and its schedule, ten steps of ``build_train_step`` (remat none/full,
gradient accumulation 1/2, int8 compression), int8 quantization byte for
byte, the synthetic batches byte for byte, checkpoints written by either
package and restored by the other, and ``train_lm``'s crash-and-resume
through ``sdk.Platform``.

Weights cross by ``repro_torch.bridge``; inputs come from numpy seeds.
Everything runs on the CPU, where the port's kernels take their plain
versions.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.parallel import ParallelPlan as JaxPlan  # noqa: E402
from repro.config.shapes import ShapeConfig as JaxShape  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import compress as jax_compress  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_step import build_train_step as jax_build_train_step  # noqa: E402
from repro.training.train_step import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config.parallel import ParallelPlan  # noqa: E402
from repro_torch.config.shapes import ShapeConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.training import checkpoint, compress, data, optimizer, train_lm  # noqa: E402
from repro_torch.training.train_step import (TrainState, abstract_train_state,  # noqa: E402
                                             build_train_step, init_train_state)

TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_kernels.py::_tol, float32
SHAPE = dict(name="t", seq_len=32, global_batch=4, kind="train")


def _jax_paths(tree):
    return {name: leaf for name, leaf in jax_ckpt._flatten_with_names(tree)}


def _to_torch_state(jstate) -> TrainState:
    """A JAX ``TrainState`` as the port's, leaf for leaf (bridge)."""
    tree = lambda t: bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, t), "cpu")
    residual = (None if jstate.residual is None
                else compress.CompressedState(tree(jstate.residual.residual)))
    opt = optimizer.AdamWState(torch.tensor(int(jstate.opt.step), dtype=torch.int32),
                               tree(jstate.opt.mu), tree(jstate.opt.nu))
    return TrainState(tree(jstate.params), opt, residual)


def _assert_trees_close(tstate, jstate, **tol):
    want = _jax_paths(jstate)
    got = dict(checkpoint.flatten_with_names(tstate))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        assert t.shape == w.shape, name
        if tol:
            np.testing.assert_allclose(bridge.to_numpy(t), w.astype(np.float32), err_msg=name, **tol)
        else:
            assert str(t.dtype).removeprefix("torch.") == w.dtype.name, name
            np.testing.assert_array_equal(bridge.to_numpy(t), w.astype(np.float32), err_msg=name)


# ---------------------------------------------------------------- AdamW
def test_cosine_schedule_matches_reference():
    for step in range(0, 40):
        want = float(jax_opt._cosine_lr(jnp.float32(step), 3e-4, 5, 30))
        np.testing.assert_allclose(optimizer._cosine_lr(step, 3e-4, 5, 30), want, rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 3.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, grad_scale):
    """Two updates of a tree with a stacked [L, in, out] leaf, a matrix, a stacked
    norm [L, D] (ndim 2: decayed, as in the reference) and a vector (not decayed)."""
    rng = np.random.default_rng(0)
    shapes = {"blocks": {"w": (3, 8, 16), "norm": (3, 8)}, "head": (8, 16), "bias": (16,)}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    draw = lambda s: jnp.asarray(rng.standard_normal(s).astype(np.float32), jdt)
    jparams = jax.tree_util.tree_map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jstate, state = jax_opt.adamw_init(jparams), optimizer.adamw_init(params)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    for _ in range(2):
        jgrads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(grad_scale * rng.standard_normal(p.shape).astype(np.float32),
                                  p.dtype), jparams)
        grads = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jgrads), "cpu")
        jparams, jstate, jm = jax_opt.adamw_update(jgrads, jstate, jparams, **kw)
        params, state, m = optimizer.adamw_update(grads, state, params, **kw)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 2
    assert {str(t.dtype) for _, t in tree_items(params)} == {f"torch.{dtype}"}
    assert {t.dtype for tree in (state.mu, state.nu) for _, t in tree_items(tree)} == {torch.float32}
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    for got, want in ((params, jparams), (state.mu, jstate.mu), (state.nu, jstate.nu)):
        wflat = {"/".join(str(p.key) for p in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
        for path, t in tree_items(got):
            np.testing.assert_allclose(bridge.to_numpy(t), np.asarray(wflat[path], np.float32),
                                       err_msg=path, **tol)


# ------------------------------------------------------------ the step
# (remat, grad_accum, compress_grads, lr). With int8 compression the run is held at a
# smaller lr: the quantizer's buckets are discontinuous, and XLA and torch sum in
# another order (losses agree to ~1e-7), so from step 3 on some int8 values land a
# bucket or more apart (9 of wq's 8192 at step 3, 1847 at step 10), and AdamW turns
# each into a parameter difference of up to lr. On identical inputs the int8 bytes
# are equal (test_quantize_..., test_error_feedback_...).
STEP_CASES = [("none", 1, False, 1e-2), ("full", 1, False, 1e-2), ("none", 2, False, 1e-2),
              ("full", 2, False, 1e-2), ("none", 2, True, 1e-3)]


@pytest.mark.parametrize("remat,accum,compress_grads,lr", STEP_CASES,
                         ids=["remat-none", "remat-full", "accum-2", "remat-full-accum-2",
                              "accum-2-int8"])
def test_ten_train_steps_match_reference(remat, accum, compress_grads, lr):
    """granite-8b smoke in float32, ten steps of a fresh batch each: the loss, grad
    norm and lr of every step, then every leaf of the state."""
    jcfg = jax_get_smoke("granite-8b").replace(dtype="float32")
    japi = jax_build(jcfg)
    jplan = JaxPlan(remat=remat, grad_accum=accum, compress_grads=compress_grads).restrict_to(())
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jplan)
    api = build(get_smoke("granite-8b").replace(dtype="float32"), device="cpu")
    plan = ParallelPlan(remat=remat, grad_accum=accum, compress_grads=compress_grads)
    state = _to_torch_state(jstate)
    kw = dict(lr=lr, warmup_steps=2, total_steps=20)
    jstep = jax.jit(jax_build_train_step(japi, jplan, **kw))
    step = build_train_step(api, plan, **kw)
    for i in range(10):
        batch = jax_data.make_batch(jcfg, JaxShape(**SHAPE), i)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        state, m = step(state, data.to_device(batch, "cpu", torch.float32))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=2e-3,
                                       err_msg=f"step {i} {key}")
    assert int(state.opt.step) == 10
    _assert_trees_close(state, jstate, **TOL)


def test_grad_accumulation_sums_in_float32(monkeypatch):
    """bf16 parameters: with accumulation the AdamW update receives float32
    gradients (summed in float32 buffers), without it the parameters' dtype."""
    from repro_torch.training import train_step

    api = build(get_smoke("granite-8b"), device="cpu")
    seen = []

    def spy(grads, *a, **k):
        seen.append({t.dtype for _, t in tree_items(grads)})
        return optimizer.adamw_update(grads, *a, **k)

    monkeypatch.setattr(train_step, "adamw_update", spy)
    batch = data.to_device(data.make_batch(api.cfg, ShapeConfig(**SHAPE), 0), "cpu", torch.bfloat16)
    for accum in (1, 2):
        plan = ParallelPlan(remat="none", grad_accum=accum)
        state = train_step.init_train_state(api, torch.Generator().manual_seed(0), plan)
        build_train_step(api, plan)(state, batch)
    assert seen == [{torch.bfloat16}, {torch.float32}]


# ------------------------------------------------------ compression
def test_quantize_gives_the_references_int8_bytes():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    cases = [ties] + [(rng.standard_normal(n) * s).astype(np.float32)
                      for n, s in ((64, 1.0), (1000, 1e-3), (7, 50.0))] + [np.zeros(5, np.float32)]
    for x in cases:
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            xj = jnp.asarray(x, jdt)
            qj, sj = jax_compress.quantize(xj)
            q, s = compress.quantize(bridge.to_tensor(np.asarray(xj), "cpu"))
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert q.numpy().tobytes() == np.asarray(qj).tobytes()
            assert s.numpy().tobytes() == np.asarray(sj).tobytes()
            assert x is not ties or q.numpy().tolist()[1:4] == [0, 2, 2]   # half to even


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(1)
    jres = {"a": jnp.zeros((16,), jnp.float32), "b": jnp.zeros((4, 8), jnp.float32)}
    jstate = jax_compress.CompressedState(jres)
    state = compress.CompressedState(bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, jres), "cpu"))
    for _ in range(5):
        g = {"a": rng.standard_normal(16).astype(np.float32) * 0.01,
             "b": rng.standard_normal((4, 8)).astype(np.float32)}
        jdq, jstate = jax_compress.tree_compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), jstate)
        dq, state = compress.tree_compress_with_feedback(bridge.from_numpy_tree(g, "cpu"), state)
        for key in g:
            assert dq[key].numpy().tobytes() == np.asarray(jdq[key]).tobytes()
            assert (state.residual[key].numpy().tobytes()
                    == np.asarray(jstate.residual[key]).tobytes())


# ------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["granite-8b", "whisper-base", "internvl2-76b"])
def test_make_batch_gives_the_references_bytes(arch):
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    for step, seed, kw in ((0, 0, {}), (7, 3, {}), (2, 0, dict(batch_override=3, seq_override=5))):
        got = data.make_batch(cfg, ShapeConfig(**SHAPE), step, seed=seed, **kw)
        want = jax_data.make_batch(jcfg, JaxShape(**SHAPE), step, seed=seed, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_prefetching_loader_yields_make_batch_and_closes():
    cfg = get_smoke("granite-8b")
    loader = data.PrefetchingLoader(cfg, ShapeConfig(**SHAPE), start_step=3, num_steps=4)
    got = list(loader)
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for step, batch in got:
        want = data.make_batch(cfg, ShapeConfig(**SHAPE), step)
        assert all(batch[k].tobytes() == want[k].tobytes() for k in want)
    endless = data.PrefetchingLoader(cfg, ShapeConfig(**SHAPE))
    next(iter(endless))
    endless.close()
    assert not endless._thread.is_alive()


# ------------------------------------------------------- checkpoints
@functools.lru_cache(maxsize=None)   # JAX arrays are immutable: the tests may share it
def _jax_state(compress_grads=True):
    """granite-8b smoke in bf16 after two steps, with an int8 residual: bf16,
    float32 and int32 leaves, and every kind of leaf name."""
    jcfg = jax_get_smoke("granite-8b")
    japi = jax_build(jcfg)
    plan = JaxPlan(remat="none", compress_grads=compress_grads).restrict_to(())
    state = jax_init_train_state(japi, jax.random.PRNGKey(0), plan)
    step = jax.jit(jax_build_train_step(japi, plan, lr=1e-2, warmup_steps=2, total_steps=50))
    for i in range(2):
        state, _ = step(state, jax.tree_util.tree_map(
            jnp.asarray, jax_data.make_batch(jcfg, JaxShape(**SHAPE), i)))
    return state


def test_leaf_names_are_the_references():
    jstate = _jax_state()
    api = build(get_smoke("granite-8b"), device="cpu")
    plan = ParallelPlan(compress_grads=True)
    names = [n for n, _ in checkpoint.flatten_with_names(abstract_train_state(api, plan))]
    assert names == [n for n, _ in jax_ckpt._flatten_with_names(jstate)]
    assert {"params/blocks/attn/wq", "opt/step", "opt/mu/embed",
            "residual/residual/final_norm"} <= set(names)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jax_ckpt.save_checkpoint(str(tmp_path), 2, jstate)
    api = build(get_smoke("granite-8b"), device="cpu")
    template = abstract_train_state(api, ParallelPlan(compress_grads=True))
    state, step = checkpoint.restore_checkpoint(str(tmp_path), None, template, device="cpu")
    assert step == 2 and isinstance(state, TrainState)
    assert isinstance(state.opt, optimizer.AdamWState)
    _assert_trees_close(state, jstate)   # exact, dtypes included
    want = _to_torch_state(jstate)        # the bridge's tree
    for (name, t), (_, w) in zip(checkpoint.flatten_with_names(state),
                                 checkpoint.flatten_with_names(want)):
        assert t.dtype == w.dtype and torch.equal(t, w), name


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    jstate = _jax_state()
    state = _to_torch_state(jstate)
    path = checkpoint.save_checkpoint(str(tmp_path), 5, state)
    assert path.endswith("step_00000005") and not os.path.exists(path + ".tmp")
    abstract = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    restored, step = jax_ckpt.restore_checkpoint(str(tmp_path), None, abstract)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_corruption_detected(tmp_path):
    api = build(get_smoke("granite-8b"), device="cpu")
    state = TrainState(*_to_torch_state(_jax_state(compress_grads=False))[:2], None)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, state)
    with open(os.path.join(path, "shard_00000.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="corrupt"):
        checkpoint.restore_checkpoint(str(tmp_path), 1, abstract_train_state(api, ParallelPlan()),
                                      device="cpu")


def test_resume_from_a_checkpoint_is_bitwise(tmp_path):
    api = build(get_smoke("granite-8b"), device="cpu")
    plan = ParallelPlan(remat="none")
    step = build_train_step(api, plan, lr=1e-2, warmup_steps=2, total_steps=50)
    batch = lambda i: data.to_device(data.make_batch(api.cfg, ShapeConfig(**SHAPE), i), "cpu",
                                     torch.bfloat16)
    state = init_train_state(api, torch.Generator().manual_seed(0), plan)
    for i in range(2):
        state, _ = step(state, batch(i))
    checkpoint.save_checkpoint(str(tmp_path), 2, state)
    restored, _ = checkpoint.restore_checkpoint(str(tmp_path), 2, abstract_train_state(api, plan),
                                                device="cpu")
    a, ma = step(state, batch(2))
    b, mb = step(restored, batch(2))
    assert ma["loss"].item() == mb["loss"].item()
    for (name, x), (_, y) in zip(checkpoint.flatten_with_names(a), checkpoint.flatten_with_names(b)):
        assert torch.equal(x, y), name


def test_async_checkpointer_gc_and_wait(tmp_path):
    state = _to_torch_state(_jax_state(compress_grads=False))
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2)
    for i in range(4):
        ck.save(i, state)
    ck.close()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000002", "step_00000003"]
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert not ck._thread.is_alive()


# -------------------------------------------------------------- train_lm
def test_train_lm_crash_and_resume_equals_an_uninterrupted_run(tmp_path):
    """``examples/train_lm.py``'s composition on the CPU: phase 1 trains to step 2
    and crashes, phase 2 resumes from its checkpoint through the same
    ``sdk.Platform``; its losses equal those of a run that did not crash."""
    base = dict(steps=4, batch=2, seq=16, log_every=1, ckpt_every=2, device="cpu")
    state, want = train_lm.run(ckpt_dir=str(tmp_path / "straight"), **dict(base, ckpt_every=4))
    assert state is not None and sorted(want) == [1, 2, 3, 4]

    from repro_torch import sdk
    app = train_lm.train_app()
    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=2, comm_slots=1))
    platform.deploy(app)
    cmd = dict(base, ckpt_dir=str(tmp_path / "crash"))
    first = train_lm.invoke_phase(platform, app, crash_at=2, **cmd)
    second = train_lm.invoke_phase(platform, app, **cmd)
    assert not first["completed"] and second["completed"]
    got = {int(k): v for r in (first, second) for k, v in r["losses"].items()}
    assert got == want
    assert checkpoint.latest_step(cmd["ckpt_dir"]) == 4
