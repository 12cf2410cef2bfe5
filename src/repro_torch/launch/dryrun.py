# det-lint: file waive[wall-clock] reason=build and count timing in a command-line tool; reported to the operator, never journaled
"""Multi-pod dry-run: build and count every (arch x shape x mesh) cell.

Counterpart of ``repro.launch.dryrun``. For each cell it shows that the
sharding config is coherent at production size (placements propagate,
collectives are legal, the shapes fit) and extracts the roofline inputs:
per-device FLOPs, bytes and collective bytes.

The reference lowers and compiles a jitted step and reads XLA's cost and
memory analyses. The port has no compiler: ``lower_cell`` builds the eager
sharded step (``serving.engine.jit_serve_steps``,
``training.train_step.jit_train_step``) over ``launch.mesh``'s production
mesh on torch's ``fake`` process group (one process holds every rank, its
collectives do nothing), with ``meta`` parameters, cache, state and inputs
placed by the step's in-shardings; ``analyse_compiled`` runs it once under
``launch.hlo_counter.CostCounter``, which counts rank 0's local ops, the
kernels' costs and the collectives. Each cell's JSON has the reference's
keys, so ``benchmarks/roofline.py`` reads it unchanged. It is priced on
``H100_SXM`` by default. ``main`` counts the cells in one worker process a
core (each on one fake group of 512 ranks, the single-pod mesh on its first
256); ``tools/dryrun_table.py`` prints a directory's cells as a table.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch.config import ModelConfig
from repro_torch.config.parallel import H100_SXM, HardwareSpec, ParallelPlan
from repro_torch.config.shapes import SHAPE_ORDER, SHAPES, ShapeConfig, applicability
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.hlo_analysis import RooflineTerms, parse_collectives
from repro_torch.launch.hlo_counter import CorrectedCosts, CostCounter
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.launch.specs import extras_for, prefill_input_specs, train_batch_specs
from repro_torch.models.model import build
from repro_torch.serving.engine import jit_serve_steps
from repro_torch.sharding.constraints import activation_constraints
from repro_torch.sharding.rules import place, place_tree
from repro_torch.training.train_step import jit_train_step, place_state

MESHES = {"single": ("single_pod_16x16", False), "multi": ("multi_pod_2x16x16", True)}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    return 2.0 * n * shape.tokens


def default_plan(shape: ShapeConfig, mesh) -> ParallelPlan:
    if shape.kind == "train":
        plan = ParallelPlan(remat="full", zero3=True)
    else:
        plan = ParallelPlan(remat="none", zero3=False)
    return plan.restrict_to(mesh.mesh_dim_names)


@dataclasses.dataclass
class LoweredCell:
    """One cell's step, ready to run: ``fn(*args)`` with ``args`` on ``meta``
    tensors, placed by the step's in-shardings; ``context`` is entered around
    the run (the activation constraints, when asked for)."""
    fn: Callable
    args: Tuple[Any, ...]
    context: Callable[[], Any] = contextlib.nullcontext


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: Optional[ParallelPlan] = None,
               constrain_acts: bool = False) -> LoweredCell:
    """Build one cell's step. The step runs on ``sharding.rules.step_mesh``'s mesh (a
    multi-pod mesh's (pod x data, model) view), and the activation constraints on the
    mesh of its inputs. The train state's step counter is a host tensor, as
    ``adamw_init`` makes it (AdamW reads it as a Python int)."""
    api = build(cfg, device="meta")
    plan = (plan or default_plan(shape, mesh)).restrict_to(mesh.mesh_dim_names)

    def context(sharding):
        if not constrain_acts:
            return contextlib.nullcontext
        return lambda: activation_constraints(sharding.mesh,
                                              plan.restrict_to(sharding.mesh.mesh_dim_names))

    if shape.kind == "train":
        batch = train_batch_specs(cfg, shape)
        fn, abstract, state_sh, batch_sh = jit_train_step(api, plan, mesh, batch)
        abstract = abstract._replace(opt=abstract.opt._replace(
            step=torch.zeros((), dtype=torch.int32)))
        return LoweredCell(fn, (place_state(abstract, state_sh), place_tree(batch, batch_sh)),
                           context(state_sh.opt.step))
    extras = tuple(extras_for(cfg, shape.global_batch))
    prefill, decode, (psh, csh, tsh) = jit_serve_steps(api, plan, mesh, shape.global_batch,
                                                       shape.seq_len, extras=extras)
    params = place_tree(api.abstract_params(), psh)
    if shape.kind == "prefill":
        return LoweredCell(prefill, (params, *(place(t, tsh)
                                               for t in prefill_input_specs(cfg, shape))),
                           context(tsh))
    cache = place_tree(api.abstract_cache(shape.global_batch, shape.seq_len), csh)
    tokens = torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")
    return LoweredCell(decode, (params, cache, place(tokens, tsh)), context(tsh))


def _storages(tree) -> Dict[int, float]:
    """Each distinct storage under ``tree`` (a DTensor's local shard): key -> bytes."""
    out: Dict[int, float] = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = (t._local_tensor if isinstance(t, DTensor) else t).untyped_storage()
            out[st._cdata] = float(st.nbytes())
    return out


def memory_of(args, outputs, counter: CostCounter) -> Dict[str, Any]:
    """The reference's memory keys, per device. ``argument_bytes`` and
    ``output_bytes`` are the local shards' bytes; ``alias_bytes`` the outputs
    that are arguments updated in place (the decode cache, the train state);
    ``temp_bytes`` the peak of live bytes the step allocated, less its new
    outputs, so ``peak_bytes_per_device`` = arguments + that peak.
    ``generated_code_bytes`` is None: eager PyTorch generates no code."""
    arg, out, live = _storages(args), _storages(outputs), counter.live_keys()
    new_out = sum(b for k, b in out.items() if k in live)
    mem = {
        "argument_bytes": sum(arg.values()),
        "output_bytes": sum(out.values()),
        "temp_bytes": counter.peak_bytes - new_out,
        "alias_bytes": sum(b for k, b in out.items() if k in arg),
        "generated_code_bytes": None,
    }
    mem["peak_bytes_per_device"] = (mem["argument_bytes"] + mem["output_bytes"]
                                    + mem["temp_bytes"] - mem["alias_bytes"])
    return mem


def analyse_compiled(lowered: LoweredCell, mesh, cfg: ModelConfig, shape: ShapeConfig,
                     hw: HardwareSpec) -> Tuple[Dict[str, Any], CorrectedCosts]:
    """Run the cell's step once under a ``CostCounter``; the cell's ``devices``,
    ``memory``, ``cost_raw``, ``collectives_flat``, ``cost_corrected`` and
    ``roofline``, and the counts. Every op is counted each time it runs, so the
    raw and the corrected costs are the same numbers."""
    ndev = mesh_devices(mesh)
    with lowered.context(), CostCounter() as counter:
        outputs = lowered.fn(*lowered.args)
    cc = counter.costs()
    out: Dict[str, Any] = {"devices": ndev, "memory": memory_of(lowered.args, outputs, counter)}
    out["cost_raw"] = {"flops": cc.flops, "bytes_accessed": cc.hbm_bytes}
    out["collectives_flat"] = parse_collectives(cc.events, ndev).to_json()
    out["cost_corrected"] = {"flops": cc.flops, "hbm_bytes": cc.hbm_bytes,
                             "collectives": cc.collectives_json(),
                             "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                                         for k, v in cc.kernels.items()},
                             "flops_by_op": {k: v[1] for k, v in cc.ops.items() if v[1]}}
    terms = RooflineTerms(
        chips=ndev,
        flops_per_device=cc.flops,
        hbm_bytes_per_device=cc.hbm_bytes,
        collective_link_bytes_per_device=cc.collective_link_bytes,
        collective_operand_bytes_per_device=cc.collective_operand_bytes,
        peak_flops=hw.peak_flops,
        hbm_bw=hw.hbm_bandwidth,
        ici_bw=hw.ici_bandwidth,
        model_flops=model_flops(cfg, shape),
    )
    out["roofline"] = terms.to_json()
    out["counted_over_model_flops"] = cc.flops * ndev / terms.model_flops
    return out, cc


def ops_table(cc: CorrectedCosts) -> str:
    """The per-op count table of a cell, largest bytes first: the port's stand-in
    for the reference's HLO text."""
    lines = [f"{'op':48s} {'calls':>8s} {'flops':>14s} {'bytes':>14s}"]
    for name, (calls, fl, by) in sorted(cc.ops.items(), key=lambda kv: -kv[1][2]):
        lines.append(f"{name:48s} {int(calls):8d} {fl:14.6e} {by:14.6e}")
    for ev in cc.events:
        lines.append(f"collective {ev.op} operand {ev.operand_bytes:.0f} output "
                     f"{ev.output_bytes:.0f} group {ev.group_size}")
    return "\n".join(lines) + "\n"


def run_cell(arch_id: str, shape_name, mesh, mesh_name: str, hw: HardwareSpec = H100_SXM,
             plan: Optional[ParallelPlan] = None, keep_hlo: Optional[str] = None,
             constrain_acts: bool = False, cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One cell's JSON. ``lower_s`` is the time to build the step and place its
    ``meta`` arguments; ``compile_s`` the time of the one counted run (there is no
    compile step). ``shape_name`` names one of ``SHAPES`` or is a ``ShapeConfig``;
    ``cfg`` overrides ``get_config(arch_id)`` (a smoke config, a depth cut)."""
    cfg = cfg or get_config(arch_id)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    cell: Dict[str, Any] = {"arch": arch_id, "shape": shape.name, "mesh": mesh_name}
    skip = applicability(cfg, shape)
    if skip:
        cell["skipped"] = skip
        return cell
    t0 = time.time()
    lowered = lower_cell(cfg, shape, mesh, plan, constrain_acts=constrain_acts)
    t1 = time.time()
    analysis, cc = analyse_compiled(lowered, mesh, cfg, shape, hw)
    t2 = time.time()
    cell.update(analysis)
    cell["lower_s"] = round(t1 - t0, 2)
    cell["compile_s"] = round(t2 - t1, 2)
    if keep_hlo:
        with open(keep_hlo, "w") as f:
            f.write(ops_table(cc))
    return cell


def _plan_for(args, shape: ShapeConfig, mesh) -> Optional[ParallelPlan]:
    overrides: Dict[str, Any] = {}
    if args.remat and shape.kind == "train":
        overrides["remat"] = args.remat
    if args.grad_accum and shape.kind == "train":
        overrides["grad_accum"] = args.grad_accum
    if args.pure_dp:
        # fold the model axis into data parallelism: no TP
        overrides.update(tensor_axes=(), expert_axes=(), data_axes=("pod", "data", "model"),
                         fsdp_axes=("pod", "data", "model"))
    if not overrides:
        return None
    return dataclasses.replace(default_plan(shape, mesh), **overrides).restrict_to(
        mesh.mesh_dim_names)


def _one(args, kind: str, arch: str, shape_name: str, mesh) -> Tuple[str, str]:
    """Run one cell and write its JSON: (OK, SKIP or FAIL, the line to print)."""
    mesh_name = MESHES[kind][0]
    tag = f"{arch}_{shape_name}_{mesh_name}".replace(".", "p")
    try:
        cell = run_cell(arch, shape_name, mesh, mesh_name,
                        plan=_plan_for(args, SHAPES[shape_name], mesh),
                        keep_hlo=(os.path.join(args.out, tag + ".ops.txt")
                                  if args.keep_hlo else None),
                        constrain_acts=args.constrain_acts)
        if "skipped" in cell:
            status, line = "SKIP", f"SKIP {tag}: {cell['skipped']}"
        else:
            r = cell["roofline"]
            status = "OK"
            line = (f"OK   {tag}: compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                    f"collective={r['collective_s']:.3e}s bottleneck={r['bottleneck']} "
                    f"flops/model_flops={cell['counted_over_model_flops']:.4f} "
                    f"peak={cell['memory']['peak_bytes_per_device'] / 1e9:.3f}GB "
                    f"(lower {cell['lower_s']}s count {cell['compile_s']}s)")
    except Exception as e:
        cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}
        status, line = "FAIL", f"FAIL {tag}: {type(e).__name__}: {e}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(cell, f, indent=1)
    return status, line


_WORKER_MESHES: Dict[str, Any] = {}


def _worker(job) -> Tuple[str, str]:
    """One cell, in this process or in a worker process: the process's fake group has
    the multi-pod mesh's 512 ranks, and the single-pod mesh takes the first 256."""
    args, kind, arch, shape_name = job
    if not _WORKER_MESHES:
        torch.set_num_threads(1)
        _WORKER_MESHES["multi"] = make_production_mesh(multi_pod=True)
    if kind not in _WORKER_MESHES:
        _WORKER_MESHES[kind] = make_production_mesh(multi_pod=MESHES[kind][1])
    return _one(args, kind, arch, shape_name, _WORKER_MESHES[kind])


def main(argv=None) -> None:
    """Count the grid: the cells run in a pool of one worker process a core this process
    may use (``os.sched_getaffinity``), or in this process when there is one cell or
    one core."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="write each cell's per-op count table (<tag>.ops.txt)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--constrain-acts", action="store_true",
                    help="enable activation sharding constraints")
    ap.add_argument("--pure-dp", action="store_true",
                    help="drop tensor parallelism (the model axis joins data)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPE_ORDER) if args.shape == "all" else args.shape.split(",")
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    # the training cells and the deepest models first: they take longest
    jobs = sorted(((args, k, a, s) for k in kinds for a in archs for s in shapes),
                  key=lambda j: (SHAPES[j[3]].kind != "train", -get_config(j[2]).num_layers))
    workers = min(len(jobs), len(os.sched_getaffinity(0)))

    os.makedirs(args.out, exist_ok=True)
    tally = {"OK": 0, "SKIP": 0, "FAIL": 0}
    with (multiprocessing.get_context("spawn").Pool(workers) if workers > 1
          else contextlib.nullcontext()) as pool:
        for status, line in (pool.imap_unordered(_worker, jobs) if pool else map(_worker, jobs)):
            tally[status] += 1
            print(line, flush=True)
    print(f"\ndry-run done: {tally['OK']} ok, {tally['SKIP']} skipped, {tally['FAIL']} failed")
    if tally["FAIL"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
