"""End-to-end training CLI.

Counterpart of ``repro.launch.train``, with its flags, plus ``--device``
(the card unless the caller asks for the CPU). Runs real steps with the full
fault-tolerance loop: async checkpointing every ``--ckpt-every`` steps,
automatic restore from the latest checkpoint at startup (a checkpoint
written by the reference's loop restores here too), and bitwise-resumable
data order.

As the reference does, the step runs on a ``(world, 1)`` mesh over
("data", "model"), ZeRO-3 when the world is larger than one: the state is
placed by ``make_train_state_specs`` and ``jit_train_step`` runs it, each
rank on its shard. A world of more than one needs the caller's process
group (``torch.distributed.init_process_group``); a world of one is started
here and torn down at the end. Checkpoints hold the state whole, written by
rank 0, so a checkpoint restores in a world of any size.

    python -m repro_torch.launch.train --arch whisper-base --steps 20            # the card
    python -m repro_torch.launch.train --arch granite-8b --smoke --steps 50 \\
        --batch 8 --seq 256 --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.config.parallel import ParallelPlan
from repro_torch.config.shapes import ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import train_batch_specs
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import build
from repro_torch.sharding.rules import gather
from repro_torch.training.checkpoint import (AsyncCheckpointer, host_tree, latest_step,
                                             restore_checkpoint)
from repro_torch.training.data import PrefetchingLoader, to_device
from repro_torch.training.train_step import (abstract_train_state, init_train_state,
                                             jit_train_step, place_state)


@dataclass
class TrainRun:
    """What one ``run`` trained, keyed by step (counted from 1): each step's loss,
    gradient norm, and seconds (the step alone, the device synchronised on both
    sides)."""
    losses: Dict[int, float] = field(default_factory=dict)
    grad_norms: Dict[int, float] = field(default_factory=dict)
    step_s: Dict[int, float] = field(default_factory=dict)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> TrainRun:
    """Train to ``args.steps`` from the latest checkpoint under ``args.ckpt_dir``
    (or from ``args.seed``); returns the steps this run took."""
    started = not dist.is_initialized()
    world = _world()
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = args.device
    if device == "cuda" and world > 1:
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg, device=device)
    plan = ParallelPlan(
        remat=args.remat,
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
        zero3=world > 1,
    ).restrict_to(("data", "model"))
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    try:
        mesh = make_mesh((world, 1), ("data", "model"), device_type=api.device.type)
        if rank == 0:
            print(f"arch={cfg.name} params={api.param_count() / 1e6:.1f}M devices={world} "
                  f"device={api.device}")
        step_fn, _, state_sh, _ = jit_train_step(api, plan, mesh, train_batch_specs(cfg, shape),
                                                 lr=args.lr, total_steps=args.steps)
        return _train(args, api, plan, shape, step_fn, state_sh, rank)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, api, plan, shape, step_fn, state_sh, rank: int) -> TrainRun:
    cfg = api.cfg
    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start_step = restore_checkpoint(args.ckpt_dir, None, abstract_train_state(api, plan),
                                               device=api.device)
        if rank == 0:
            print(f"restored checkpoint at step {start_step}")
    else:
        gen = torch.Generator(device=api.device).manual_seed(args.seed)
        state = init_train_state(api, gen, plan)
    state = place_state(state, state_sh)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir and rank == 0 else None
    loader = PrefetchingLoader(cfg, shape, start_step=start_step,
                               num_steps=args.steps - start_step, seed=args.seed)
    dtype = torch_dtype(cfg.dtype)
    out = TrainRun()
    t0 = time.perf_counter()  # det-lint: waive[wall-clock] reason=CLI report of real training
    tokens_done = 0
    try:
        for step, host_batch in loader:
            batch = to_device(host_batch, api.device, dtype)
            _sync(api.device)
            ts = time.perf_counter()  # det-lint: waive[wall-clock] reason=step time of real training
            state, metrics = step_fn(state, batch)
            _sync(api.device)
            te = time.perf_counter()  # det-lint: waive[wall-clock] reason=step time of real training
            out.step_s[step + 1] = te - ts
            out.losses[step + 1] = float(gather(metrics["loss"]))
            out.grad_norms[step + 1] = float(gather(metrics["grad_norm"]))
            tokens_done += args.batch * args.seq
            if rank == 0 and ((step + 1) % args.log_every == 0 or step == start_step):
                dt = time.perf_counter() - t0  # det-lint: waive[wall-clock] reason=CLI report
                print(f"step {step + 1:5d} loss {out.losses[step + 1]:7.4f} grad_norm "
                      f"{out.grad_norms[step + 1]:8.3f} tok/s {tokens_done / dt:,.0f}")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                host = host_tree(state)   # every rank: the sharded leaves are gathered
                if ckpt:
                    ckpt.save(step + 1, host)
    finally:
        loader.close()
        if ckpt:
            ckpt.close()
    if ckpt:
        print(f"final checkpoint at {args.ckpt_dir}")
    if rank == 0:
        print("training done")
    return out


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
