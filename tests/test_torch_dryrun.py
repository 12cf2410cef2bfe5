"""The port's dry-run (``repro_torch.launch.dryrun``, ``hlo_counter``,
``hlo_analysis.parse_collectives``) against the reference's, and the faults
of the sharded steps at production size that it found.

  * Each kernel's ``meta`` route gives its plain version's output shapes and
    dtypes, and its ``cost`` is the formula of its bound (PERF.md §6).
  * The counter: one matmul counts exactly 2·m·k·n and L of them L times; a
    matmul's bytes lie within [ideal, 4·ideal]; a serve and a train step count
    the same on ``meta`` tensors as on the CPU (the kernels by their ``cost``).
  * ``CollectiveStats.to_json()`` on the collectives of
    ``tests/test_hlo_analysis.py``'s synthetic HLO equals the reference's.
  * ``model_flops`` and ``num_active_params`` equal the reference's with ``==``.
  * In a child process on torch's ``fake`` process group (one process holds
    every rank): a sharded matmul counts the local product's FLOPs exactly; an
    L-layer sharded step counts L times one layer's collectives; a training
    step's norms see a device's share of the batch, and with grad_accum 2 their
    share of each micro-batch; the LM head's product keeps the batch's sharding
    (``constraints.place_head``); a multi-pod mesh's step
    counts as its merged (pod x data, model) view's; one smoke
    config of each family gives a cell that ``benchmarks/roofline.py`` reads
    as ``OK``; granite-8b and whisper-base ``decode_32k`` (heads fewer than
    the 16-way model axis), olmoe-1b-7b ``decode_32k`` (a sequence-sharded
    cache write) and whisper-base ``train_4k`` (the step counter, and the
    gradients of the heads' reshapes) run on ``make_production_mesh()``, and so
    do mamba2-130m and whisper-base ``train_4k`` at grad_accum 4 (smoke widths
    with their full vocabularies: the tied head's ``Partial`` logits), mamba2's
    within 5% of the FLOPs of grad_accum 1; on
    ``make_production_mesh(multi_pod=True)``, a batch of 2 (the smallest that
    ``step_mesh`` cannot merge: sharded over "pod" alone) and a plan that names
    "pod" for the tensor dims run on the three-axis mesh, where DTensor's argmax
    failed on a rank's one row.
  * granite-8b smoke's counted FLOPs lie within a stated band of the
    reference's ``corrected_costs`` on a 4-device JAX mesh (a child process
    with its own ``XLA_FLAGS``).

Run as ``python tests/test_torch_dryrun.py <dir>`` it is the fake group's
side (the module imports no JAX at the top for that reason).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SMOKE_CELLS = {"granite-8b": "prefill_32k", "olmoe-1b-7b": "prefill_32k",
               "mamba2-130m": "prefill_32k", "hymba-1.5b": "decode_32k",
               "internvl2-76b": "prefill_32k", "whisper-base": "decode_32k"}   # one a family
# (arch, shape[, grad_accum]): a cell with grad_accum runs the smoke config with the full
# config's vocabulary (mamba2-130m's 50280, whisper-base's 51865: neither divides the
# 16-way model axis), which is what made the full configs fail
FAULT_CELLS = {"F2 granite": ("granite-8b", "decode_32k"),
               "F2 whisper": ("whisper-base", "decode_32k"),
               "F3 olmoe": ("olmoe-1b-7b", "decode_32k"),
               "F5 whisper": ("whisper-base", "train_4k"),
               "F8 mamba2 accum 4": ("mamba2-130m", "train_4k", 4),
               "F8 whisper accum 4": ("whisper-base", "train_4k", 4)}
TRAIN_ACCUM = 2   # granite-8b smoke's train step on the fake (2, 2) mesh, accumulated
# the multi-pod mesh's cells that step_mesh cannot merge (granite-8b smoke; the plan
# override, if any): a batch of 2 sharded over "pod" alone, and tensor dims on "pod"
THREE_AXIS_CELLS = {"batch 2": ("decode", 1024, 2, None),
                    "tensor on pod": ("decode_32k", 32768, 128, ("pod",))}
LAYERS = (1, 2, 3)
# granite-8b smoke on a (2, 2) mesh, counted FLOPs over the reference's corrected_costs.
# decode: both count the same projections and the attention over every cache slot, so
# they agree to 1%. prefill at S = 32768: the reference's chunked attention multiplies
# every (query block, key block) pair, masked or not, where the flash kernel's cost counts
# the causal pairs only; attention is most of the smoke model's work there, so the port
# counts about half.
BANDS = {"decode_32k": (0.99, 1.01), "prefill_32k": (0.45, 0.55)}


# ------------------------------------------------------------ the fake group's side
def _child(out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.config.shapes import SHAPES
    from repro_torch.launch.dryrun import default_plan, lower_cell, run_cell
    from repro_torch.launch.hlo_counter import corrected_costs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.rules import step_mesh

    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    a = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, (Shard(0), Replicate()))
    b = distribute_tensor(torch.empty(32, 48, device="meta"), mesh, (Replicate(), Shard(1)))
    cc = corrected_costs(lambda: a @ b)
    out["matmul"] = {"flops": cc.flops, "mm": cc.ops["aten.mm"][0], "events": len(cc.events)}
    out["layers"] = {}
    for n in LAYERS:
        cell = lower_cell(get_smoke("granite-8b").replace(num_layers=n), SHAPES["decode_32k"],
                          mesh)
        cc = corrected_costs(cell.fn, *cell.args)
        out["layers"][n] = {"flops": cc.flops, "collectives": cc.collectives_json()}
    out["smoke"] = {arch: run_cell(arch, shape, mesh, "fake_2x2", cfg=get_smoke(arch))
                    for arch, shape in SMOKE_CELLS.items()}
    out["train"] = run_cell("granite-8b", "train_4k", mesh, "fake_2x2",
                            cfg=get_smoke("granite-8b"))["cost_corrected"]["kernels"]
    out["train_accum"] = run_cell(
        "granite-8b", "train_4k", mesh, "fake_2x2", cfg=get_smoke("granite-8b"),
        plan=dataclasses.replace(default_plan(SHAPES["train_4k"], mesh), grad_accum=TRAIN_ACCUM)
    )["cost_corrected"]["kernels"]
    out["head"] = _head_product(mesh)
    out["band"] = {shape: run_cell("granite-8b", shape, mesh, "fake_2x2",
                                   cfg=get_smoke("granite-8b"))["cost_corrected"]["flops"]
                   for shape in BANDS}
    dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    pods = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    flat = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    plan = default_plan(SHAPES["decode_32k"], pods)
    view, view_plan = step_mesh(pods, plan, (128,))
    out["view"] = {"shape": list(view.shape), "names": list(view.mesh_dim_names),
                   "data_axes": list(view_plan.data_axes),
                   "kept": [step_mesh(pods, plan, (2,))[0] is pods,
                            step_mesh(pods, dataclasses.replace(plan, tensor_axes=("pod",)))[0]
                            is pods]}
    out["view"]["cells"] = {}
    for name, m in (("pods", pods), ("flat", flat)):
        cell = run_cell("granite-8b", "decode_32k", m, name, cfg=get_smoke("granite-8b"))
        out["view"]["cells"][name] = [cell["cost_corrected"]["flops"],
                                      cell["cost_corrected"]["hbm_bytes"], cell["collectives_flat"]]
    dist.destroy_process_group()
    mesh = make_production_mesh()
    out["faults"], out["accum_one"] = {}, {}
    for name, (arch, shape, *accum) in FAULT_CELLS.items():
        cfg = plan = None
        if accum:
            cfg = get_smoke(arch).replace(vocab_size=get_config(arch).vocab_size)
            plan = dataclasses.replace(default_plan(SHAPES[shape], mesh), grad_accum=accum[0])
            out["accum_one"][name] = run_cell(arch, shape, mesh, "single_pod_16x16", cfg=cfg)
        try:
            out["faults"][name] = run_cell(arch, shape, mesh, "single_pod_16x16", plan=plan,
                                           cfg=cfg)
        except Exception as e:   # the test names the fault
            out["faults"][name] = {"error": f"{type(e).__name__}: {e}"}
    dist.destroy_process_group()
    out["three_axis"] = _three_axis()
    dist.destroy_process_group()
    with open(Path(out_dir) / "dryrun.json", "w") as f:
        json.dump(out, f)


def _head_product(mesh):
    """The LM head's product on the (2, 2) fake mesh: rows [8, 16, 32] sharded over data
    times a tied head [32, 250] sharded along its embed dim over data (ZeRO-3): the
    counted FLOPs and the logits' local shape through ``place_head``, and DTensor's own
    product's."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.hlo_counter import corrected_costs
    from repro_torch.sharding.constraints import place_head

    x = distribute_tensor(torch.empty(8, 16, 32, device="meta"), mesh, (Shard(0), Replicate()))
    w = distribute_tensor(torch.empty(32, 250, device="meta"), mesh, (Shard(0), Replicate()))
    out = {}
    for name, head in (("place_head", lambda: place_head(w, x)), ("dtensor", lambda: w)):
        got = {}
        cc = corrected_costs(lambda: got.setdefault("y", x @ head()))
        out[name] = {"flops": cc.ops["aten.mm"][1], "local": list(got["y"].to_local().shape),
                     "placements": [str(p) for p in got["y"].placements]}
    return out


def _three_axis():
    """The multi-pod mesh's cells that ``step_mesh`` keeps on three axes, and DTensor's
    argmax over vocab-sharded logits with one row a rank beside ``argmax_last``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.config.shapes import SHAPES, ShapeConfig
    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import default_plan, run_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.constraints import argmax_last
    from repro_torch.sharding.rules import step_mesh

    pods = make_production_mesh(multi_pod=True)
    plan = default_plan(SHAPES["decode_32k"], pods)
    out = {"refused": [b for b in range(1, 9) if step_mesh(pods, plan, (b,))[0] is pods],
           "cells": {}}
    for name, (kind, seq, batch, tensor_axes) in THREE_AXIS_CELLS.items():
        shape = ShapeConfig(f"{kind}_b{batch}", seq_len=seq, global_batch=batch, kind="decode")
        cell_plan = default_plan(shape, pods)
        if tensor_axes:
            cell_plan = dataclasses.replace(cell_plan, tensor_axes=tensor_axes)
        out["cells"][name] = {"merged": step_mesh(pods, cell_plan, (batch,))[0] is not pods}
        try:
            cell = run_cell("granite-8b", shape, pods, "multi_pod_2x16x16", plan=cell_plan,
                            cfg=get_smoke("granite-8b"))
            out["cells"][name].update(flops=cell["cost_corrected"]["flops"],
                                      devices=cell["devices"])
        except Exception as e:   # the test names the fault
            out["cells"][name]["error"] = f"{type(e).__name__}: {e}"
    logits = distribute_tensor(torch.zeros(2, 64), pods, (Shard(0), Replicate(), Shard(1)))
    out["argmax_last"] = list(argmax_last(logits).to_local().shape)
    try:
        torch.argmax(logits, dim=-1)
        out["argmax"] = "ok"
    except RuntimeError as e:
        out["argmax"] = str(e)
    return out


_REFERENCE = """
import json, sys
import numpy as np
import jax
from repro.config.shapes import SHAPES
from repro.configs import get_smoke
from repro.launch.dryrun import lower_cell
from repro.launch.hlo_counter import corrected_costs
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
print(json.dumps({s: corrected_costs(lower_cell(get_smoke("granite-8b"), SHAPES[s], mesh)
                                     .compile().as_text(), 4).flops for s in sys.argv[1:]}))
"""


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    """The fake group's results, and the reference's FLOPs for ``BANDS``' shapes."""
    tmp = tmp_path_factory.mktemp("dryrun")
    src = os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])
    child = subprocess.Popen([sys.executable, __file__, str(tmp)],
                             env=dict(os.environ, PYTHONPATH=src), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, *BANDS], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                                  XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    log = child.communicate(timeout=600)[0]
    assert child.returncode == 0, log[-6000:]
    assert ref.returncode == 0, ref.stderr[-6000:]
    with open(tmp / "dryrun.json") as f:
        return json.load(f), json.loads(ref.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ kernels on meta
def _kernel_inputs(name, device):
    """(the ops entry's args, keywords, the cost's args, keywords, PERF.md §6's
    (flops, bytes)) for one small call of each kernel, from a numpy seed."""
    rng = np.random.default_rng(3)
    t = lambda *shape, dtype=torch.float32: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype).to(device)
    bf = torch.bfloat16
    if name == "rmsnorm":
        x, s = t(3, 5, 64, dtype=bf), t(64, dtype=bf)
        return (x, s), {}, (x, s), {}, (4.0 * 960, (2 * 960 + 64) * 2)
    if name == "flash_attention":
        q, k, v = t(2, 24, 4, 16, dtype=bf), t(2, 24, 2, 16, dtype=bf), t(2, 24, 2, 16, dtype=bf)
        pairs = sum(min(i + 1, 24) - max(0, i - 8 + 1) for i in range(24))   # causal, window 8
        return ((q, k, v), {"window": 8}, (q, k, v), {"window": 8},
                (4.0 * 2 * 4 * 16 * pairs, (2 * 24 * 4 + 2 * 24 * 2) * 2 * 16 * 2))
    if name == "decode_attention":
        b, s, hq, hkv, dh = 2, 32, 4, 2, 16
        q, kc, vc = t(b, hq, dh, dtype=bf), t(b, s, hkv, dh, dtype=bf), t(b, s, hkv, dh, dtype=bf)
        slot = torch.arange(s, dtype=torch.int32).repeat(b, 1).to(device)
        cur = torch.tensor([31, 20], dtype=torch.int32).to(device)
        return ((q, kc, vc, slot, cur), {}, (q, kc, vc, slot, cur), {},
                (4.0 * hq * dh * b * s, 2 * b * s * hkv * dh * 2 + b * hq * dh * 4 + (b * s + b) * 4))
    if name == "moe_gmm":
        xe, we = t(4, 8, 16, dtype=bf), t(4, 16, 12, dtype=bf)
        live = torch.tensor([[3], [8], [0], [5]], dtype=torch.int32).to(device)
        return ((xe, we, live), {}, (xe, we), {},
                (2.0 * 32 * 16 * 12, (32 * 16 + 4 * 16 * 12 + 32 * 12) * 2))
    x, a = t(1, 32, 3, 8, dtype=bf), -t(1, 32, 3).abs()
    bm, cm = t(1, 32, 4, dtype=bf), t(1, 32, 4, dtype=bf)
    l, nc = 16, 2
    flops = nc * (l * (l + 1.0) * 4 + 3 * (l * (l + 1.0) * 8 + 4.0 * l * 8 * 4))
    return ((x, a, bm, cm), {"chunk": 16}, (x, a, bm, cm), {"chunk": 16},
            (flops, (2 * 32 * 3 * 8 + 2 * 32 * 4) * 2 + (32 * 3 + 3 * 8 * 4) * 4))


KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "moe_gmm", "ssd")


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_meta_route_has_the_plain_shapes_and_the_bound_cost(name):
    import importlib

    from repro_torch.kernels import ops

    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    args, kw, cargs, ckw, (flops, nbytes) = _kernel_inputs(name, "cpu")
    margs, mkw, mcargs, mckw, _ = _kernel_inputs(name, "meta")
    want = getattr(ops, name)(*args, **kw)
    ops.reset_launch_counts()
    got = getattr(ops, name)(*margs, **mkw)
    want, got = (w if isinstance(w, tuple) else (w,) for w in (want, got))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got) and ops.launch_counts()[name] == 0
    assert tuple(mod.cost(*cargs, **ckw)) == tuple(mod.cost(*mcargs, **mckw)) == (flops, nbytes)


# ------------------------------------------------------------ the counter
def test_matmul_flops_exact():
    from repro_torch.launch.hlo_counter import corrected_costs

    a, b = torch.empty(96, 40, device="meta"), torch.empty(40, 72, device="meta")
    assert corrected_costs(lambda: a @ b).flops == 2 * 96 * 40 * 72


@pytest.mark.parametrize("layers", (1, 4))
def test_a_loop_of_matmuls_counts_each_iteration(layers):
    """The reference corrects a scan's body by its trip count; eager layers are seen
    once each time they run."""
    from repro_torch.launch.hlo_counter import corrected_costs

    w = torch.empty(64, 64, device="meta")

    def step(x):
        for _ in range(layers):
            x = torch.tanh(x @ w)
        return x

    cc = corrected_costs(step, torch.empty(16, 64, device="meta"))
    assert cc.flops == layers * 2 * 16 * 64 * 64
    assert cc.ops["aten.mm"][0] == cc.ops["aten.tanh"][0] == layers


def test_matmul_bytes_within_bounds():
    from repro_torch.launch.hlo_counter import corrected_costs

    a, b = torch.empty(256, 128, dtype=torch.bfloat16), torch.empty(128, 512, dtype=torch.bfloat16)
    ideal = (256 * 128 + 128 * 512 + 256 * 512) * 2
    assert ideal <= corrected_costs(lambda: a @ b).hbm_bytes <= 4 * ideal


@pytest.mark.parametrize("arch", ("granite-8b", "olmoe-1b-7b", "mamba2-130m", "whisper-base"))
def test_a_step_counts_the_same_on_meta_as_on_the_cpu(arch):
    """A prefill and a decode step of the smoke config: the kernels count by their
    ``cost`` and none of the plain versions' ops, so FLOPs, bytes and per-kernel
    calls agree whether the tensors hold data or not."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.hlo_counter import corrected_costs
    from repro_torch.launch.specs import extras_for
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build
    from repro_torch.serving.engine import build_serve_steps

    cfg = get_smoke(arch)
    counts = {}
    for device in ("cpu", "meta"):
        api = build(cfg, device=device)
        params = (api.init_params(torch.Generator().manual_seed(0)) if device == "cpu"
                  else api.abstract_params())
        steps = build_serve_steps(api)
        tokens = torch.zeros((2, 32), dtype=torch.int32, device=device)
        plens = torch.tensor([32, 20], dtype=torch.int32, device=device)
        extras = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=device),
                          extras_for(cfg, 2))

        def run():
            with torch.no_grad():
                logits, cache = steps.prefill(params, tokens, plens, **extras)
                steps.decode(params, cache, torch.zeros(2, dtype=torch.int32, device=device))

        cc = corrected_costs(run)
        counts[device] = (cc.flops, cc.hbm_bytes, cc.kernels, cc.ops)
    assert counts["cpu"] == counts["meta"]
    assert counts["cpu"][2]


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "mamba2-130m"))
def test_a_train_step_counts_the_same_on_meta_as_on_the_cpu(arch):
    """One training step of the smoke config: each kernel's forward counts by its
    ``cost`` and its backward, a kernel scope of its own (``<name>_backward``: the
    formula on the CPU, empty outputs on ``meta``), by its ``backward_cost``, alike
    on ``meta`` tensors and on the CPU."""
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.configs import get_smoke
    from repro_torch.launch.hlo_counter import corrected_costs
    from repro_torch.launch.specs import extras_for
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build
    from repro_torch.training.train_step import (abstract_train_state, build_train_step,
                                                 init_train_state)

    cfg, plan = get_smoke(arch), ParallelPlan(remat="full")
    counts = {}
    for device in ("cpu", "meta"):
        api = build(cfg, device=device)
        if device == "cpu":
            state = init_train_state(api, torch.Generator().manual_seed(0), plan)
        else:   # the step counter on the host, as adamw_init makes it
            state = abstract_train_state(api, plan)
            state = state._replace(opt=state.opt._replace(step=torch.zeros((), dtype=torch.int32)))
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, 32), dtype=np.int32)).to(device)
        batch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1),
                 **tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=device),
                            extras_for(cfg, 2))}
        cc = corrected_costs(build_train_step(api, plan), state, batch)
        counts[device] = (cc.flops, cc.hbm_bytes, cc.kernels, cc.ops)
    assert counts["cpu"] == counts["meta"]
    kernel = "moe_gmm" if arch == "olmoe-1b-7b" else "ssd"
    assert {"rmsnorm", "rmsnorm_backward", kernel, f"{kernel}_backward"} <= set(counts["cpu"][2])


# ------------------------------------------------------------ collectives
def test_collective_stats_equal_the_reference_on_the_synthetic_hlo():
    """``tests/test_hlo_analysis.py``'s module: a 4-way all-gather of f32[16,128] to
    f32[64,128] and a 4-way all-reduce of f32[16,128], on 16 devices."""
    import importlib.util

    from repro.launch.hlo_analysis import parse_collectives as jax_parse_collectives
    from repro_torch.launch.hlo_analysis import parse_collectives
    from repro_torch.launch.hlo_counter import CollectiveEvent

    spec = importlib.util.spec_from_file_location("_ref_hlo_tests",
                                                  ROOT / "tests" / "test_hlo_analysis.py")
    ref_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tests)
    events = [CollectiveEvent("all-gather", 16 * 128 * 4, 64 * 128 * 4, 4),
              CollectiveEvent("all-reduce", 16 * 128 * 4, 16 * 128 * 4, 4)]
    assert parse_collectives(events, 16).to_json() == \
        jax_parse_collectives(ref_tests._SYNTH_HLO, 16).to_json()


# ------------------------------------------------------------ model_flops
ARCHS = ("deepseek-67b", "glm4-9b", "qwen2.5-32b", "granite-8b", "whisper-base", "hymba-1.5b",
         "internvl2-76b", "mamba2-130m", "olmoe-1b-7b", "qwen3-moe-235b-a22b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.fixture
def reference_dryrun(monkeypatch):
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512 host devices:
    the variable is restored after the test, so that later child processes of this
    worker do not start 512 devices."""
    if "XLA_FLAGS" in os.environ:
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    import repro.launch.dryrun as ref

    return ref


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(reference_dryrun, arch, shape):
    from repro.config.shapes import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_get_config
    from repro_torch.config.shapes import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import model_flops

    got = model_flops(get_config(arch), SHAPES[shape])
    assert got == reference_dryrun.model_flops(jax_get_config(arch), JAX_SHAPES[shape]) and got > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_num_active_params_equal_the_reference(arch):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.num_active_params() == ref.num_active_params()
    assert (cfg.num_active_params() < cfg.num_params()) == (cfg.family == "moe")


# ------------------------------------------------------------ on the fake group
def test_a_sharded_matmul_counts_the_local_product(fake):
    """[64, 32] batch-sharded over data times [32, 48] column-sharded over model: each
    device multiplies [32, 32] by [32, 24], once, with no collective."""
    got = fake[0]["matmul"]
    assert got == {"flops": 2 * 32 * 32 * 24, "mm": 1, "events": 0}


def test_an_l_layer_step_counts_l_times_one_layers_collectives(fake):
    """granite-8b smoke's decode step on (2, 2) at 1, 2 and 3 layers: each layer adds
    the same collectives and FLOPs, and some all-reduce."""
    layers = {int(n): v for n, v in fake[0]["layers"].items()}
    one = {k: v["count"] for k, v in layers[1]["collectives"].items()}
    step = {k: layers[2]["collectives"][k]["count"] - one.get(k, 0)
            for k in layers[2]["collectives"]}
    assert step.get("all-reduce", 0) > 0
    for n in LAYERS:
        got = {k: v["count"] for k, v in layers[n]["collectives"].items()}
        assert got == {k: one.get(k, 0) + (n - 1) * step.get(k, 0) for k in set(one) | set(step)}
    per_layer = layers[2]["flops"] - layers[1]["flops"]
    assert per_layer > 0 and layers[3]["flops"] - layers[2]["flops"] == per_layer


def test_a_training_step_shards_the_batch(fake):
    """granite-8b smoke's ZeRO-3 train step on (2, 2): every norm a device runs sees
    its half of the batch (256 x 4096 tokens of width 64), not all of it: the
    embedding lookup all-gathers the table over the data axis and keeps the
    tokens' sharding, where it took the tokens whole."""
    rms = fake[0]["train"]["rmsnorm"]
    assert rms["calls"] > 0 and rms["flops"] == rms["calls"] * 4.0 * (256 // 2) * 4096 * 64


def test_an_accumulated_training_step_shards_each_micro_batch(fake):
    """The same step with grad_accum 2: each norm sees its share of each micro-batch
    (256 / 2 / 2 sequences), twice as many calls, the same FLOPs. The micro-batches
    were DTensor slices of the batch, which come back replicated: each norm saw all
    128 sequences of a micro-batch."""
    one, rms = fake[0]["train"]["rmsnorm"], fake[0]["train_accum"]["rmsnorm"]
    assert rms["calls"] == TRAIN_ACCUM * one["calls"]
    assert rms["flops"] == one["flops"] == \
        rms["calls"] * 4.0 * (256 // TRAIN_ACCUM // 2) * 4096 * 64


def test_the_lm_head_keeps_the_batch_sharding(fake):
    """``place_head`` gathers the tied head over the data axis and splits its 250
    columns over the model axis (125 a rank): each device multiplies its 4 rows by its
    125 columns. (DTensor's own product's placements and FLOPs are printed on failure.)"""
    head = fake[0]["head"]
    got = head["place_head"]
    assert got["placements"] == ["S(0)", "S(2)"], head
    assert got["local"] == [4, 16, 125] and got["flops"] == 2.0 * 4 * 16 * 32 * 125, head


@pytest.mark.parametrize("arch", sorted(SMOKE_CELLS))
def test_a_smoke_cell_reads_as_ok_in_the_roofline(fake, arch):
    sys.path.insert(0, str(ROOT))
    from benchmarks.roofline import rows_from_cells

    cell = fake[0]["smoke"][arch]
    (row,) = rows_from_cells([cell])
    assert row["status"] == "OK", cell.get("error")
    assert row["step_s"] > 0 and row["hbm_gb_per_dev"] > 0
    assert cell["roofline"]["flops_per_device"] == cell["cost_corrected"]["flops"] > 0
    mem = cell["memory"]
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes"] + mem["output_bytes"]
                                            + mem["temp_bytes"] - mem["alias_bytes"])


@pytest.mark.parametrize("shape", sorted(BANDS))
def test_granite_smoke_flops_within_the_band_of_the_reference(fake, shape):
    got, want = fake[0]["band"][shape], fake[1][shape]
    lo, hi = BANDS[shape]
    assert lo <= got / want <= hi, (got, want, got / want)


def test_a_multi_pod_step_runs_on_the_merged_view(fake):
    """``sharding.rules.step_mesh`` on a (2, 2, 2) ("pod", "data", "model") mesh: the
    default plan runs on the (4, 2) view of the same devices, and granite-8b smoke's
    decode cell there counts the FLOPs, bytes and collectives of a (4, 2) mesh; a batch
    of 2 (sharded over pod alone on the mesh) and a plan that names pod without data
    keep the mesh."""
    view = fake[0]["view"]
    assert (view["shape"], view["names"], view["data_axes"]) == ([4, 2], ["data", "model"],
                                                                 ["data"])
    assert view["kept"] == [True, True]
    assert view["cells"]["pods"] == view["cells"]["flat"]
    assert view["cells"]["pods"][2]["counts"]["all-reduce"] > 0


def test_step_mesh_keeps_three_axes_for_a_batch_of_two_first():
    """The smallest batch that ``step_mesh`` cannot merge on the 2 x 16 x 16 mesh under
    the default plan: 2 divides "pod" (2) but not pod x data (32), so the batch shards
    over "pod" alone on the mesh and not at all on the (32, 16) view. Stub meshes: no
    process group."""
    from types import SimpleNamespace

    from repro_torch.sharding.rules import _batch_shards, step_mesh
    from repro_torch.config.parallel import ParallelPlan

    plan = ParallelPlan()
    pods = SimpleNamespace(axis_names=("pod", "data", "model"),
                           shape={"pod": 2, "data": 16, "model": 16})
    view = SimpleNamespace(axis_names=("data", "model"), shape={"data": 32, "model": 16})
    view_plan = plan.restrict_to(view.axis_names)
    differ = [b for b in range(1, 65) if _batch_shards(plan, pods, b)
              != _batch_shards(view_plan, view, b)]
    assert differ[:3] == [2, 4, 6] and 32 not in differ and 64 not in differ
    assert step_mesh(pods, plan, (2,)) == (pods, plan)   # a stub is no DeviceMesh: kept


@pytest.mark.parametrize("name", sorted(THREE_AXIS_CELLS))
def test_a_step_runs_on_three_axes_where_the_view_cannot_merge(fake, reference_dryrun, name):
    """On ``make_production_mesh(multi_pod=True)`` granite-8b smoke's decode at a batch
    of 2 (sharded over "pod" alone) and with the tensor dims on "pod" stay on the
    three-axis mesh and run there; each cell's ``model_flops`` equals the reference's,
    which lowers both cells (PERF.md §6 gives the reference's counts beside the
    port's). DTensor's own argmax over the vocab-sharded logits of a one-row rank fails
    ("shape '[1, 16, 16, 1]' is invalid for input of size 16"); the decode step takes
    ``constraints.argmax_last``, which gathers the vocab first."""
    from repro.config.shapes import ShapeConfig as JaxShapeConfig
    from repro.configs import get_smoke as jax_get_smoke
    from repro_torch.config.shapes import ShapeConfig
    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import model_flops

    three = fake[0]["three_axis"]
    assert three["refused"] == [2, 4, 6, 8]
    cell = three["cells"][name]
    assert not cell["merged"]
    assert "error" not in cell, cell["error"]
    assert cell["devices"] == 512 and cell["flops"] > 0
    assert three["argmax_last"] == [1] and "is invalid for input of size 16" in three["argmax"]
    kind, seq, batch, _ = THREE_AXIS_CELLS[name]
    args = (f"{kind}_b{batch}", seq, batch, "decode")
    assert model_flops(get_smoke("granite-8b"), ShapeConfig(*args)) == \
        reference_dryrun.model_flops(jax_get_smoke("granite-8b"), JaxShapeConfig(*args)) > 0


ACCUM_CELLS = sorted(k for k, v in FAULT_CELLS.items() if len(v) > 2)


@pytest.mark.parametrize("fault", [k for k in ACCUM_CELLS if k.startswith("F8 mamba2")])
def test_grad_accumulation_keeps_the_counted_flops(fake, reference_dryrun, fault):
    """mamba2-130m smoke (its full vocabulary) ``train_4k`` on the 16 x 16 mesh with
    grad_accum 4: the counted FLOPs a device within 5% of grad_accum 1 (the reference's
    do not move with it), each norm call on a quarter of the rows of grad_accum 1's
    (its data rank's 4 of a micro-batch's 64 sequences), and ``model_flops`` the
    reference's."""
    from repro.config.shapes import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_get_config, get_smoke as jax_get_smoke

    arch, shape, accum = FAULT_CELLS[fault]
    cell, one = fake[0]["faults"][fault], fake[0]["accum_one"][fault]
    assert "error" not in cell, cell["error"]
    flops, flops_one = cell["cost_corrected"]["flops"], one["cost_corrected"]["flops"]
    assert abs(flops / flops_one - 1) <= 0.05, (flops, flops_one)
    rms, rms_one = (c["cost_corrected"]["kernels"]["rmsnorm"] for c in (cell, one))
    assert rms["calls"] == accum * rms_one["calls"] and rms["flops"] == rms_one["flops"]
    assert rms["flops"] / rms["calls"] == rms_one["flops"] / rms_one["calls"] / accum
    jcfg = jax_get_smoke(arch).replace(vocab_size=jax_get_config(arch).vocab_size)
    assert cell["roofline"]["model_flops"] == one["roofline"]["model_flops"] == \
        reference_dryrun.model_flops(jcfg, JAX_SHAPES[shape]) > 0


@pytest.mark.parametrize("fault", sorted(FAULT_CELLS))
def test_a_sharded_step_runs_at_production_size(fake, fault):
    """F2: granite-8b's 8 KV heads and whisper-base's 8 heads on a 16-way model axis
    (DTensor cannot unflatten them unevenly); F3: olmoe-1b-7b's cache is sharded
    along S, and its write indexed by a boolean mask (no ``meta`` kernel); F5:
    AdamW read the step counter of a ``meta`` state as an int; F8: with grad_accum 4
    the tied head's logits were ``Partial`` (replicated micro-batch rows times a head
    sharded along its embed dim), and DTensor's gather of them failed ("too many
    indices for tensor of dimension 2")."""
    cell = fake[0]["faults"][fault]
    assert "error" not in cell, cell["error"]
    assert cell["devices"] == 256 and cell["cost_corrected"]["flops"] > 0
    assert math.isfinite(cell["roofline"]["step_time_s"])


if __name__ == "__main__":
    torch.set_num_threads(1)
    _child(sys.argv[1])
