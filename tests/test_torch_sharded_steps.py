"""The port's sharded steps over gloo worlds of 2 and 4 ranks against its
unsharded steps on one rank, and ``compress_psum`` against the reference's.

The module's fixture writes the inputs (float32 smoke configs on weights
carried across from the reference's PRNGKey(0) by ``repro_torch.bridge``,
prompts and batches from a numpy seed) under ``tmp_path``, then runs this
file as a script once per world size, both at once. Each script spawns its
ranks over a ``file://`` store; every case runs inside the ranks and every
rank saves what it gathered. The tests compare in this process:

  * ``jit_serve_steps`` (granite dense, olmoe MoE, whisper encdec with
    ``frames``, mamba2 SSM through ``ssd``'s route, hymba hybrid, internvl2 vlm
    with ``patches``) on (2, 1), (1, 2) and (2, 2), granite on (2, 2) also
    inside ``activation_constraints``, and
    granite on (1, 4), a model axis larger than its 2 KV heads: a
    prefill and 4 decode steps give ``build_serve_steps``'s logits within
    the float32 ``_tol`` and its tokens wherever the top-2 logit gap exceeds it;
  * ``jit_train_step`` on (2, 1) with ZeRO-3 and on (1, 2): granite and olmoe
    (remat "none"), mamba2, hymba, whisper and internvl2 (the default plan), and
    on (2, 1) granite with grad_accum 2, int8 compression, remat "dots" and
    without ZeRO-3, olmoe and mamba2 with grad_accum 2, mamba2 with grad_accum 4
    (micro-batches of one row, which no data axis divides): 2 steps' loss, grad
    norm and every updated leaf within ``_tol`` of ``build_train_step`` with the
    same plan, the embed dim's local shard 1/data of the whole under ZeRO-3;
  * the micro-batches of a batch placed over the data axes on (2, 1), (4, 1),
    (2, 2) and (pod, data, model) = (2, 2, 1): each holds the reference's rows,
    placed as a batch of its size;
  * ``take_last`` of ``Partial`` and of unevenly vocab-sharded logits, and its
    gradient, against the plain gather;
  * flash attention with heads sharded on (1, 2) gathers nothing, and a
    cumsum along a sharded dim sees the whole dim after ``unshard``;
  * olmoe's MoE layer on (2, 1) with its tokens in 4 routing groups: each rank's
    ``moe_gmm`` calls take half the groups' rows and count half of one rank's
    FLOPs, the output and the gradients of x and every weight within ``_tol`` of
    one rank's; a decode batch's one group keeps the replicated route;
  * ``launch.train`` in a world of 2 equals a world of 1 (losses, grad norms,
    the step-4 checkpoint), and its step-2 checkpoint resumes in a world of 1;
  * ``compress_psum`` equals the reference's under ``jax.vmap`` where the
    replicas' scales agree, and on ROADMAP C's smallest input its residual is
    the error of what was sent, where the reference's is not.

Run as ``python tests/test_torch_sharded_steps.py <world> <dir>`` it is the
ranks' side (the module imports no JAX at the top for that reason).
"""
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
F32_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_kernels.py::_tol, float32
TOL = F32_TOL["atol"]

SERVE_ARCHS = ("granite-8b", "olmoe-1b-7b", "whisper-base", "mamba2-130m", "hymba-1.5b",
               "internvl2-76b")
SERVE_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
CONSTRAINED = {(2, 2): ("granite-8b",)}   # serve cases also run inside activation_constraints
# serve cases on a model axis larger than the smoke config's 2 KV heads
FEW_KV_HEADS = {(1, 4): ("granite-8b",)}
# train cases: (mesh, arch, plan name); each plan's keywords to ParallelPlan, and its lr
PLANS = {"": dict(remat="none"), "default": {}, "accum-2": dict(remat="none", grad_accum=2),
         "accum-4": dict(remat="none", grad_accum=4), "int8": dict(remat="none", compress_grads=True),
         "remat-dots": dict(remat="dots"), "no-zero3": dict(remat="none", zero3=False)}
# tests/test_torch_train_step.py::STEP_CASES holds int8 compression at the smaller lr
PLAN_LR = {"int8": 1e-3}
TRAIN_CASES = ([(shape, arch, "") for shape in ((2, 1), (1, 2))
                for arch in ("granite-8b", "olmoe-1b-7b")]
               + [(shape, arch, "default") for shape in ((2, 1), (1, 2))
                  for arch in ("mamba2-130m", "hymba-1.5b", "whisper-base", "internvl2-76b")]
               + [((2, 1), "granite-8b", plan)
                  for plan in ("accum-2", "int8", "remat-dots", "no-zero3")]
               + [((2, 1), arch, "accum-2") for arch in ("olmoe-1b-7b", "mamba2-130m")]
               + [((2, 1), "mamba2-130m", "accum-4")])
TRAIN_ARCHS = tuple(dict.fromkeys(arch for _, arch, _ in TRAIN_CASES))
# take_last cases in the world of 4: (mesh, placements: P Partial, R Replicate, S Shard(2),
# the vocabulary); 10 on 4 ranks and 9 on 2 are uneven spans (3, 3, 3, 1 and 5, 4)
TAKE_LAST_CASES = {"uneven vocab": ((1, 4), "RS", 10), "partial": ((2, 2), "PR", 8),
                   "partial, uneven vocab": ((2, 2), "PS", 9)}
# micro-batch cases: (mesh, batch, grad_accum); the world is the mesh's size, a mesh of
# three axes is (pod, data, model), the batch over pod and data
MICRO_CASES = (((2, 1), 4, 2), ((2, 1), 4, 4), ((2, 1), 6, 3), ((2, 1), 8, 2),
               ((4, 1), 8, 2), ((4, 1), 12, 3), ((4, 1), 8, 4), ((2, 2), 8, 2),
               ((2, 2, 1), 8, 2), ((2, 2, 1), 12, 3), ((2, 2, 1), 8, 4))
B, S, DECODE_STEPS, TRAIN_STEPS = 4, 16, 4, 2
PROMPT_LENS = (16, 9, 12, 5)
LR = 1e-2
LAUNCH = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32", "--log-every", "1",
          "--ckpt-every", "2", "--lr", "1.0"]
# the MoE layer's routing group sizes over B x S tokens (B x S / 16 = 4 groups: the rows
# shard over the data axis) and over a decode step's B tokens (one group: replicated)
MOE_GROUPS = {"rows": 16, "decode": B}
C_INPUT = np.array([[1.0, 0.3, -0.2, 0.05], [100.0, 0.0, 0.0, 0.0]], np.float32)


def _f32_smoke(arch):
    from repro_torch.configs import get_smoke

    return get_smoke(arch).replace(dtype="float32")


def _psum_inputs():
    """(g, residual) [2, 6] of two replicas whose scales agree (the same largest
    magnitude), and ROADMAP C's smallest input with zero residuals."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((2, 6)).astype(np.float32)
    g[:, 0] = [1.5, -1.5]
    res = (rng.standard_normal((2, 6)) * 1e-3).astype(np.float32)
    res[:, 0] = 0.0
    return {"equal": (g, res), "roadmap_c": (C_INPUT, np.zeros_like(C_INPUT))}


# ------------------------------------------------------------ the ranks' side
def _serve_case(api, params, inputs, mesh, plan, constrained=False):
    import contextlib

    from repro_torch.serving.engine import jit_serve_steps
    from repro_torch.sharding.constraints import activation_constraints
    from repro_torch.sharding.rules import gather, place_tree

    extras = tuple(inputs["extras"][api.cfg.name])
    prefill, decode, (psh, _, _) = jit_serve_steps(api, plan, mesh, B, S, extras=extras)
    dparams = place_tree(params, psh)
    with activation_constraints(mesh, plan) if constrained else contextlib.nullcontext():
        logits, cache = prefill(dparams, inputs["tokens"], inputs["prompt_lens"],
                                *inputs["extras"][api.cfg.name].values())
        out = {"logits": [gather(logits)], "tokens": []}
        for tok in inputs["feed"][api.cfg.name]:   # the one-rank run's tokens
            logits, nxt, cache = decode(dparams, cache, tok)
            out["logits"].append(gather(logits))
            out["tokens"].append(gather(nxt))
    return out


def _plan(name):
    from repro_torch.config.parallel import ParallelPlan

    return ParallelPlan(**PLANS[name]).restrict_to(("data", "model"))


def _init_state(params, plan):
    from repro_torch.models.common import tree_map
    from repro_torch.training.compress import init_residual
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState

    params = tree_map(torch.clone, params)
    return TrainState(params, adamw_init(params),
                      init_residual(params) if plan.compress_grads else None)


def _train_case(api, params, inputs, mesh, plan_name):
    from repro_torch.models.common import tree_items
    from repro_torch.sharding.rules import gather
    from repro_torch.training.train_step import jit_train_step

    plan = _plan(plan_name)
    batches = inputs["train"][api.cfg.name]
    fn, _, _, _ = jit_train_step(api, plan, mesh, batches[0], lr=PLAN_LR.get(plan_name, LR),
                                 warmup_steps=1)
    state = _init_state(params, plan)
    out = {"loss": [], "grad_norm": []}
    for batch in batches:
        state, metrics = fn(state, batch)
        out["loss"].append(float(gather(metrics["loss"])))
        out["grad_norm"].append(float(gather(metrics["grad_norm"])))
    out["params"] = {path: gather(x) for path, x in tree_items(state.params)}
    emb = state.params["embed"]
    out["embed"] = (tuple(emb.shape), tuple(emb.to_local().shape), tuple(emb.placements))
    return out


def _mesh_axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _microbatch_case(mesh, b, accum):
    """Each micro-batch of a [b, 3] int32 and a [b, 2, 5] float32 leaf placed over the
    data axes: (placements, local shape, whole value) a leaf."""
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.models.common import tree_map
    from repro_torch.sharding.rules import gather, place_tree, tree_batch_shardings
    from repro_torch.training.train_step import _split_microbatches

    plan = ParallelPlan(**PLANS["accum-2"]).restrict_to(mesh.mesh_dim_names)
    batch = {"tokens": torch.arange(b * 3, dtype=torch.int32).reshape(b, 3),
             "frames": torch.arange(b * 10, dtype=torch.float32).reshape(b, 2, 5) / 7}
    batch = place_tree(batch, tree_batch_shardings(batch, plan, mesh))
    return [tree_map(lambda x: (tuple(x.placements), tuple(x.to_local().shape), gather(x)), mb)
            for mb in _split_microbatches(batch, accum, plan)]


def _take_last_case(mesh, placements, vocab):
    """``take_last`` of [2, 3, vocab] logits placed by ``placements`` (a ``Partial`` mesh
    dim holds addends of the logits, a ``Shard(2)`` one an uneven span of the vocab
    where ``vocab`` does not divide): (its whole value, the plain gather; this rank's
    local gradient, the plain gradient's local part)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.sharding.constraints import take_last

    gen = torch.Generator().manual_seed(5)
    full, weight = torch.randn(2, 3, vocab, generator=gen), torch.randn(2, 3, generator=gen)
    idx = torch.randint(0, vocab, (2, 3), generator=gen)
    part = full.clone()
    for i, p in enumerate(placements):
        if isinstance(p, Partial):   # rank r of this mesh dim holds (r + 1) / (1 + 2 + ...)
            n = mesh.size(i)
            part = part * (mesh.get_local_rank(i) + 1) / (n * (n + 1) / 2)
    shape, off = compute_local_shape_and_global_offset(
        full.shape, mesh, [Replicate() if isinstance(p, Partial) else p for p in placements])
    cols = slice(off[2], off[2] + shape[2])
    local = part[:, :, cols].clone().requires_grad_(True)
    x = DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape,
                           stride=full.stride())
    got = take_last(x, idx).full_tensor()
    (got * weight).sum().backward()
    grad = torch.zeros_like(full).scatter(-1, idx[..., None], weight[..., None])
    return {"got": got.detach(), "want": torch.gather(full, -1, idx[..., None])[..., 0],
            "grad": local.grad, "want_grad": grad[:, :, cols]}


def _flash_collectives(mesh):
    """Collectives, output and plain output of flash attention with q/k/v heads
    sharded over the model axis."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import plain

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 16, h, 16, generator=gen) for h in (8, 2, 2))
    heads = (Replicate(), Shard(2))
    dq, dk, dv = (distribute_tensor(t, mesh, heads) for t in (q, k, v))
    with CommDebugMode() as comm:
        out = ops.flash_attention(dq, dk, dv, causal=True)
    return {"collectives": comm.get_total_counts(), "placements": tuple(out.placements),
            "out": out.full_tensor(), "plain": plain(q, k, v, causal=True)}


def _scan_of_a_sharded_dim(mesh):
    """A cumsum along a dim sharded over the data axis, after ``unshard``, and the
    plain cumsum (the MoE layer's expert ranks scan so)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.sharding.constraints import unshard

    x = torch.arange(24, dtype=torch.int32).reshape(2, 12) % 5
    dx = distribute_tensor(x, mesh, (Shard(1), Replicate()))
    got = torch.cumsum(unshard(dx, -1), dim=-1, dtype=torch.int32)
    return {"got": got.full_tensor(), "want": torch.cumsum(x, dim=-1, dtype=torch.int32),
            "placements": tuple(unshard(dx, -1).placements)}


def _moe_layer(mesh, moe_inputs, name):
    """olmoe smoke's MoE layer (block 0's weights, the expert FFN's F over the data axis as
    the serve rules place it) on ``MOE_GROUPS[name]``-token routing groups of x sharded
    over the data axis: each ``moe_gmm`` call's xe placements, local xe shape and output
    placements, the ``moe_gmm`` FLOPs this rank counts, the output, and the gradients of
    (y · gy).sum() + aux for x and each weight, gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_counter import CostCounter
    from repro_torch.models import moe

    cfg = _f32_smoke("olmoe-1b-7b")
    rep = (Replicate(), Replicate())
    place = {"router": rep, "w_gate": (Shard(2), Replicate()), "w_up": (Shard(2), Replicate()),
             "w_down": (Shard(1), Replicate())}
    x, gy = (moe_inputs[k][name] for k in ("x", "gy"))
    calls, real = [], ops.moe_gmm

    def seen(xe, we, live=None):
        out = real(xe, we, live)
        if isinstance(xe, DTensor):
            calls.append((tuple(xe.placements), tuple(xe.to_local().shape), tuple(out.placements)))
        return out

    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    ops.moe_gmm = seen
    try:
        with implicit_replication():
            dx, dgy = (distribute_tensor(t, mesh, (Shard(0), Replicate())) for t in (x, gy))
            dp = {k: distribute_tensor(v, mesh, place[k]) for k, v in moe_inputs["params"].items()}
            with torch.no_grad(), CostCounter() as counter:
                y, _ = moe.apply_moe(dx, dp, cfg, group_size=MOE_GROUPS[name])
            forward_calls = list(calls)
            leaves = [t.requires_grad_(True) for t in (dx, *dp.values())]
            y2, aux = moe.apply_moe(dx, dp, cfg, group_size=MOE_GROUPS[name])
            grads = torch.autograd.grad(full((y2 * dgy).sum() + aux), leaves)
    finally:
        ops.moe_gmm = real
    return {"calls": forward_calls, "flops": counter.kernels["moe_gmm"][1], "y": full(y),
            "grads": [full(g) for g in grads]}


def _launch_train(tmp):
    from repro_torch.launch import train

    train.get_smoke = _f32_smoke
    run = train.run(train.parser().parse_args([*LAUNCH, "--steps", "4",
                                               "--ckpt-dir", str(tmp / "launch_w2")]))
    return {"losses": run.losses, "grad_norms": run.grad_norms}


def _rank_main(rank, world, tmp):
    tmp = Path(tmp).resolve()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / f'store{world}'}",
                            rank=rank, world_size=world)
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build
    from repro_torch.training.compress import compress_psum

    inputs = torch.load(tmp / "inputs.pt")
    out = {}
    with torch.no_grad():
        for shape in SERVE_MESHES[world]:
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            plan = ParallelPlan().restrict_to(("data", "model"))
            for arch in SERVE_ARCHS:
                api = build(_f32_smoke(arch), device="cpu")
                out[("serve", arch, shape)] = _serve_case(api, inputs["params"][arch], inputs,
                                                          mesh, plan)
            for arch in CONSTRAINED.get(shape, ()):
                api = build(_f32_smoke(arch), device="cpu")
                out[("constrained", arch, shape)] = _serve_case(
                    api, inputs["params"][arch], inputs, mesh, plan, constrained=True)
        for shape, archs in FEW_KV_HEADS.items():
            if math.prod(shape) != world:
                continue
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            plan = ParallelPlan().restrict_to(("data", "model"))
            for arch in archs:
                api = build(_f32_smoke(arch), device="cpu")
                out[("serve", arch, shape)] = _serve_case(api, inputs["params"][arch], inputs,
                                                          mesh, plan)
    if world == 2:
        for shape, arch, plan_name in TRAIN_CASES:
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            api = build(_f32_smoke(arch), device="cpu")
            out[("train", arch, shape, plan_name)] = _train_case(
                api, inputs["params"][arch], inputs, mesh, plan_name)
    if world == 4:
        from torch.distributed.tensor import Partial, Replicate, Shard

        for name, (shape, placements, vocab) in TAKE_LAST_CASES.items():
            out[("take_last", name)] = _take_last_case(
                make_mesh(shape, ("data", "model"), device_type="cpu"),
                tuple({"P": Partial(), "R": Replicate(), "S": Shard(2)}[p] for p in placements),
                vocab)
    for shape, b, accum in MICRO_CASES:
        if math.prod(shape) == world:
            out[("micro", shape, b, accum)] = _microbatch_case(
                make_mesh(shape, _mesh_axes(shape), device_type="cpu"), b, accum)
    if world == 2:
        out["flash"] = _flash_collectives(make_mesh((1, 2), ("data", "model"), device_type="cpu"))
        out["cumsum"] = _scan_of_a_sharded_dim(make_mesh((2, 1), ("data", "model"),
                                                         device_type="cpu"))
        for name in MOE_GROUPS:
            out[("moe", name)] = _moe_layer(make_mesh((2, 1), ("data", "model"), device_type="cpu"),
                                            inputs["moe"], name)
        for name, (g, res) in _psum_inputs().items():
            mean, new_res = compress_psum(torch.from_numpy(g[rank]), torch.from_numpy(res[rank]))
            out[("psum", name)] = (mean.numpy(), new_res.numpy())
        out["launch"] = _launch_train(tmp)
    torch.save(out, tmp / f"w{world}_rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------ the parent's side
def _extras(cfg, rng):
    """whisper's frames or internvl2's patches for B rows, float32 from ``rng``."""
    shapes = {"encdec": ("frames", cfg.encoder_frames), "vlm": ("patches", cfg.num_patches)}
    if cfg.family not in shapes:
        return {}
    name, n = shapes[cfg.family]
    return {name: torch.from_numpy(rng.standard_normal((B, n, cfg.d_model)).astype(np.float32))}


def _inputs(tmp):
    """Bridged float32 weights, prompts, frames and train batches, saved for the ranks."""
    import jax

    from repro.configs import get_smoke as jax_get_smoke
    from repro.models.model import build as jax_build
    from repro_torch import bridge

    rng = np.random.default_rng(0)
    params, extras, train = {}, {}, {}
    for arch in dict.fromkeys(SERVE_ARCHS + TRAIN_ARCHS):
        jparams = jax_build(jax_get_smoke(arch).replace(dtype="float32")).init_params(
            jax.random.PRNGKey(0))
        params[arch] = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        cfg = _f32_smoke(arch)
        extras[cfg.name] = _extras(cfg, rng)
        train[cfg.name] = [{**{key: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
                               for key in ("tokens", "targets")}, **_extras(cfg, rng)}
                           for _ in range(TRAIN_STEPS)]
    d = _f32_smoke("olmoe-1b-7b").d_model
    moe_x = {"rows": (B, S, d), "decode": (B, 1, d)}
    moe = {"params": {k: v[0] for k, v in params["olmoe-1b-7b"]["blocks"]["moe"].items()},
           **{key: {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                    for name, shape in moe_x.items()} for key in ("x", "gy")}}
    inputs = {"params": params, "extras": extras, "train": train, "moe": moe,
              "tokens": torch.from_numpy(rng.integers(0, 256, (B, S))),
              "prompt_lens": torch.tensor(PROMPT_LENS, dtype=torch.int32)}
    unsharded = {arch: _unsharded_serve(arch, inputs) for arch in SERVE_ARCHS}
    inputs["feed"] = {_f32_smoke(arch).name: [torch.argmax(l, dim=-1).to(torch.int32)
                                              for l in logits[:-1]]
                      for arch, logits in unsharded.items()}
    torch.save(inputs, tmp / "inputs.pt")
    return inputs, unsharded


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(inputs, {world: [each rank's results]}, the directory, the one-rank serve
    logits)."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs, unsharded = _inputs(tmp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {w: subprocess.Popen([sys.executable, __file__, str(w), str(tmp)], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for w in (2, 4)}
    logs = {w: p.communicate(timeout=600)[0] for w, p in procs.items()}
    for w, p in procs.items():
        assert p.returncode == 0, f"world {w} failed:\n{logs[w][-6000:]}"
    results = {w: [torch.load(tmp / f"w{w}_rank{r}.pt", weights_only=False) for r in range(w)]
               for w in (2, 4)}
    return inputs, results, tmp, unsharded


def _unsharded_serve(arch, inputs):
    from repro_torch.models.model import build
    from repro_torch.serving.engine import build_serve_steps

    api = build(_f32_smoke(arch), device="cpu")
    steps = build_serve_steps(api)
    params = inputs["params"][arch]
    with torch.no_grad():
        logits, cache = steps.prefill(params, inputs["tokens"], inputs["prompt_lens"],
                                      **inputs["extras"][api.cfg.name])
        out = [logits]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(DECODE_STEPS):
            logits, tok, cache = steps.decode(params, cache, tok)
            out.append(logits)
    return out


SERVE_CASES = ([(w, shape, arch, "serve") for w, shapes in SERVE_MESHES.items()
                for shape in shapes for arch in SERVE_ARCHS]
               + [(math.prod(shape), shape, arch, "constrained")
                  for shape, archs in CONSTRAINED.items() for arch in archs]
               + [(math.prod(shape), shape, arch, "serve")
                  for shape, archs in FEW_KV_HEADS.items() for arch in archs])


@pytest.mark.parametrize("world,shape,arch,kind", SERVE_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}{'-constrained' * (k != 'serve')}"
                              for _, s, a, k in SERVE_CASES])
def test_sharded_serve_steps_equal_the_unsharded(worlds, world, shape, arch, kind):
    """Prefill and 4 decode steps: logits within ``_tol`` of one rank's, and the same
    token wherever the one-rank top-2 gap exceeds ``_tol`` (the sharded steps decode
    the one-rank run's tokens, so a near tie cannot carry over)."""
    results, want = worlds[1], worlds[3][arch]
    for got in results[world]:
        case = got[(kind, arch, shape)]
        assert len(case["logits"]) == len(want) == DECODE_STEPS + 1
        for i, (g, w) in enumerate(zip(case["logits"], want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"step {i}", **F32_TOL)
        for i, (tok, w) in enumerate(zip(case["tokens"], want[1:])):
            top2 = torch.topk(w, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > TOL
            assert clear.any()
            assert torch.equal(tok[clear], torch.argmax(w, dim=-1).to(torch.int32)[clear]), i


@pytest.mark.parametrize("shape,arch,plan_name", TRAIN_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" + (f"-{p}" if p else "")
                              for s, a, p in TRAIN_CASES])
def test_sharded_train_step_equals_the_unsharded(worlds, shape, arch, plan_name):
    """2 steps: loss, grad norm and every updated leaf within ``_tol`` of the unsharded
    step with the same plan; ZeRO-3 leaves the embed dim sharded over the data axis,
    the vocab takes the model axis."""
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import build
    from repro_torch.training.train_step import build_train_step

    inputs, results = worlds[:2]
    api = build(_f32_smoke(arch), device="cpu")
    plan, lr = _plan(plan_name), PLAN_LR.get(plan_name, LR)
    state = _init_state(inputs["params"][arch], plan)
    step = build_train_step(api, plan, lr=lr, warmup_steps=1)
    losses, norms = [], []
    for batch in inputs["train"][api.cfg.name]:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    want = dict(tree_items(state.params))
    moved = max((want[p] - x).abs().max().item() for p, x in tree_items(inputs["params"][arch]))
    assert moved > min(5 * TOL, lr)   # the updates move the leaves past the tolerance
    for got in results[2]:
        case = got[("train", arch, shape, plan_name)]
        np.testing.assert_allclose(case["loss"], losses, **F32_TOL)
        np.testing.assert_allclose(case["grad_norm"], norms, **F32_TOL)
        assert sorted(case["params"]) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(case["params"][path].numpy(), w.detach().numpy(),
                                       err_msg=path, **F32_TOL)
        whole, local, _ = case["embed"]
        data, model = shape
        fsdp = data if plan.zero3 else 1
        assert local == (whole[0] // model, whole[1] // fsdp)   # [vocab, embed]


@pytest.mark.parametrize("shape,b,accum", MICRO_CASES,
                         ids=["x".join(map(str, s)) + f"-b{b}-accum{a}" for s, b, a in MICRO_CASES])
def test_microbatches_hold_the_reference_rows_placed_as_a_batch_of_their_size(
        worlds, shape, b, accum):
    """Micro-batch i holds rows [i*n, (i+1)*n), n = b / accum (the reference's reshape to
    (accum, n)), each rank n / ways of them: ways the data axes that divide n, the
    trailing ones shed first as ``batch_spec`` sheds them, 1 (replicated) where none
    does. DTensor's own slice of the batch-sharded leaf replicated every micro-batch."""
    from torch.distributed.tensor import Replicate, Shard

    n, data = b // accum, list(shape[:-1])
    while data and n % math.prod(data):
        data.pop()
    ways = math.prod(data)
    want_pl = tuple(Shard(0) if i < len(data) and ways > 1 else Replicate()
                    for i in range(len(shape)))
    plain = {"tokens": torch.arange(b * 3, dtype=torch.int32).reshape(b, 3),
             "frames": torch.arange(b * 10, dtype=torch.float32).reshape(b, 2, 5) / 7}
    for got in worlds[1][math.prod(shape)]:
        mbs = got[("micro", shape, b, accum)]
        assert len(mbs) == accum
        for i, mb in enumerate(mbs):
            for key, x in plain.items():
                placements, local, whole = mb[key]
                assert placements == want_pl, (i, key)
                assert local == (n // ways, *x.shape[1:]), (i, key)
                assert torch.equal(whole, x[i * n:(i + 1) * n]), (i, key)


@pytest.mark.parametrize("name", sorted(TAKE_LAST_CASES))
def test_take_last_of_partial_or_unevenly_sharded_logits(worlds, name):
    """The gold logit and its gradient, against the plain gather, where the logits are
    ``Partial`` (replicated rows times a head sharded along its embed dim: a
    micro-batch that no data axis divides, under ZeRO-3 with a tied head) or sharded
    unevenly along the vocab (hymba-1.5b's 32001 on a 16-way model axis): DTensor's own
    gather fails on the first, and a span of V // ranks a rank misplaced the second."""
    for got in worlds[1][4]:
        case = got[("take_last", name)]
        np.testing.assert_allclose(case["got"].numpy(), case["want"].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(case["grad"].numpy(), case["want_grad"].numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_flash_with_heads_sharded_gathers_nothing(worlds):
    from torch.distributed.tensor import Replicate, Shard

    for got in worlds[1][2]:
        flash = got["flash"]
        assert flash["collectives"] == 0
        assert flash["placements"] == (Replicate(), Shard(2))
        np.testing.assert_allclose(flash["out"].numpy(), flash["plain"].numpy(), **F32_TOL)


def test_a_scan_over_a_sharded_dim_sees_the_whole_dim(worlds):
    from torch.distributed.tensor import Replicate

    for got in worlds[1][2]:
        scan = got["cumsum"]
        assert scan["placements"] == (Replicate(), Replicate())
        assert torch.equal(scan["got"], scan["want"])


def _moe_layer_one_rank(moe_inputs, name):
    """``_moe_layer`` on one rank: (the moe_gmm FLOPs, the output, the gradients)."""
    from repro_torch.launch.hlo_counter import CostCounter
    from repro_torch.models import moe

    cfg = _f32_smoke("olmoe-1b-7b")
    x, gy = (moe_inputs[k][name].clone() for k in ("x", "gy"))
    p = {k: v.clone() for k, v in moe_inputs["params"].items()}
    with torch.no_grad(), CostCounter() as counter:
        y, _ = moe.apply_moe(x, p, cfg, group_size=MOE_GROUPS[name])
    leaves = [t.requires_grad_(True) for t in (x, *p.values())]
    y2, aux = moe.apply_moe(x, p, cfg, group_size=MOE_GROUPS[name])
    grads = torch.autograd.grad((y2 * gy).sum() + aux, leaves)
    return counter.kernels["moe_gmm"][1], y, grads


def _assert_moe_layer_close(case, want):
    _, y, grads = want
    np.testing.assert_allclose(case["y"].numpy(), y.numpy(), **F32_TOL)
    for name, g, w in zip(("x", "router", "w_gate", "w_up", "w_down"), case["grads"], grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **F32_TOL)


def test_moe_expert_products_shard_their_rows_over_the_data_axis(worlds):
    """ROADMAP C1: with 4 routing groups on (2, 1), each rank's three ``moe_gmm`` calls
    (gate, up, down) take the rows of its 2 groups, [E, 2C, ·], and return them sharded
    the same way; each rank counts half of one rank's ``moe_gmm`` FLOPs; the output and
    the gradients of x and of every weight (the experts' a ``Partial`` sum of the ranks'
    rows) are one rank's within ``_tol``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.moe import expert_capacity

    inputs, results = worlds[0], worlds[1]
    want = _moe_layer_one_rank(inputs["moe"], "rows")
    cfg = _f32_smoke("olmoe-1b-7b")
    groups = B * S // MOE_GROUPS["rows"]
    rows = groups * expert_capacity(cfg, MOE_GROUPS["rows"])
    sharded = (Shard(1), Replicate())
    for got in results[2]:
        case = got[("moe", "rows")]
        assert [(pl, shape[:2], out) for pl, shape, out in case["calls"]] == \
            [(sharded, (cfg.num_experts, rows // 2), sharded)] * 3
        assert case["flops"] == want[0] / 2
        _assert_moe_layer_close(case, want)


def test_a_decode_batchs_one_group_keeps_the_replicated_route(worlds):
    """A decode step routes its B tokens as one group, which the data axis cannot
    divide: each rank multiplies every row and counts one rank's FLOPs, the output
    replicated, and the output and gradients are one rank's within ``_tol``."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.moe import expert_capacity

    inputs, results = worlds[0], worlds[1]
    want = _moe_layer_one_rank(inputs["moe"], "decode")
    cfg = _f32_smoke("olmoe-1b-7b")
    rows = expert_capacity(cfg, MOE_GROUPS["decode"])
    for got in results[2]:
        case = got[("moe", "decode")]
        assert [(shape[:2], out) for _, shape, out in case["calls"]] == \
            [((cfg.num_experts, rows), (Replicate(), Replicate()))] * 3
        assert case["flops"] == want[0]
        _assert_moe_layer_close(case, want)


def _launch_world_of_one(ckpt_dir, steps=4):
    from repro_torch.launch import train

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "get_smoke", _f32_smoke)
        run = train.run(train.parser().parse_args([*LAUNCH, "--steps", str(steps),
                                                   "--ckpt-dir", str(ckpt_dir)]))
    assert not dist.is_initialized()
    return run


def _checkpoint(path):
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.training.checkpoint import flatten_with_names

    step = int(path.name.split("_")[1])
    tree, _ = restore_checkpoint(str(path.parent), step, _template(path), device="cpu")
    return dict(flatten_with_names(tree))


def _template(path):
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.models.model import build
    from repro_torch.training.train_step import abstract_train_state

    return abstract_train_state(build(_f32_smoke("granite-8b"), device="cpu"), ParallelPlan())


def _assert_checkpoints_close(got, want):
    got, want = _checkpoint(got), _checkpoint(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), err_msg=name, **F32_TOL)


def test_launch_train_in_a_world_of_two_equals_a_world_of_one(worlds, tmp_path):
    """``launch.train`` on a (2, 1) mesh with ZeRO-3: the losses, grad norms and
    step-4 checkpoint of a world of one within ``_tol``; its step-2 checkpoint,
    written whole, resumes in a world of one to the same steps 3-4."""
    results, tmp = worlds[1:3]
    two = results[2][0]["launch"]
    assert results[2][1]["launch"] == two
    one = _launch_world_of_one(tmp_path / "w1")
    assert sorted(two["losses"]) == sorted(one.losses) == [1, 2, 3, 4]
    np.testing.assert_allclose([two["losses"][k] for k in range(1, 5)],
                               [one.losses[k] for k in range(1, 5)], **F32_TOL)
    np.testing.assert_allclose([two["grad_norms"][k] for k in range(1, 5)],
                               [one.grad_norms[k] for k in range(1, 5)], **F32_TOL)
    w2 = tmp / "launch_w2"
    assert sorted(os.listdir(w2)) == ["step_00000002", "step_00000004"]
    _assert_checkpoints_close(w2 / "step_00000004", tmp_path / "w1" / "step_00000004")
    shutil.copytree(w2 / "step_00000002", tmp_path / "resume" / "step_00000002")
    resumed = _launch_world_of_one(tmp_path / "resume")
    assert sorted(resumed.losses) == [3, 4]
    np.testing.assert_allclose([resumed.losses[k] for k in (3, 4)],
                               [two["losses"][k] for k in (3, 4)], **F32_TOL)
    _assert_checkpoints_close(tmp_path / "resume" / "step_00000004", w2 / "step_00000004")


def _reference_psum(g, res):
    import jax

    from repro.training.compress import compress_psum

    mean, new_res = jax.vmap(lambda a, b: compress_psum(a, b, "d"), axis_name="d")(g, res)
    return np.asarray(mean), np.asarray(new_res)


def _ports_psum(results, name):
    per_rank = [r[("psum", name)] for r in results[2]]
    return np.stack([m for m, _ in per_rank]), np.stack([r for _, r in per_rank])


def test_compress_psum_equals_the_reference_where_scales_agree(worlds):
    g, res = _psum_inputs()["equal"]
    mean, new_res = _ports_psum(worlds[1], "equal")
    want_mean, want_res = _reference_psum(g, res)
    np.testing.assert_array_equal(mean, want_mean)
    np.testing.assert_array_equal(new_res, want_res)
    np.testing.assert_allclose(mean[0], (g + res).mean(axis=0), atol=2 * 1.5 / 127)


def test_compress_psum_feeds_back_the_error_of_what_was_sent(worlds):
    """ROADMAP C's input: replica 1's scale (100/127) is the shared one. The port's
    residual is corrected - dequantize(q_shared, scale_max), so the sent value plus
    the residual is every replica's corrected gradient; the reference's residual
    is taken against each replica's own scale and loses 0.213, 0.3, -0.2 and 0.05
    of replica 0."""
    g, res = _psum_inputs()["roadmap_c"]
    mean, new_res = _ports_psum(worlds[1], "roadmap_c")
    scale_max = np.float32(100.0) / np.float32(127.0)
    sent = np.clip(np.round(g / scale_max), -127, 127) * scale_max
    np.testing.assert_array_equal(new_res, g - sent)
    np.testing.assert_allclose(sent + new_res, g, rtol=0, atol=1e-6)
    want_mean, want_res = _reference_psum(g, res)
    np.testing.assert_array_equal(mean, want_mean)    # the same payload
    assert np.abs(want_res[0] - (g[0] - sent[0])).max() > 0.1
    np.testing.assert_allclose((sent + want_res)[0] - g[0], [-0.213, -0.3, 0.2, -0.05],
                               atol=5e-3)


if __name__ == "__main__":
    world, tmp = int(sys.argv[1]), sys.argv[2]
    torch.multiprocessing.spawn(_rank_main, args=(world, tmp), nprocs=world)
