"""End-to-end training CLI.

Counterpart of ``repro.launch.train``, with its flags, plus ``--device``
(the card unless the caller asks for the CPU). Runs real steps with the full
fault-tolerance loop: async checkpointing every ``--ckpt-every`` steps,
automatic restore from the latest checkpoint at startup (a checkpoint
written by the reference's loop restores here too), and bitwise-resumable
data order.

The step runs on a world of one. The reference places its state on a
``(devices, 1)`` mesh; here a process group of more than one rank is
refused, naming the sharded step it needs (ROADMAP A8).

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
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import build
from repro_torch.training.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.training.data import PrefetchingLoader, to_device
from repro_torch.training.train_step import (abstract_train_state, build_train_step,
                                             init_train_state)


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
    world = _world()
    if world > 1:
        raise NotImplementedError(
            f"training on a mesh of {world} devices needs the sharded train step "
            "(ROADMAP A8); this CLI runs on a world of one")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg, device=args.device)
    plan = ParallelPlan(
        remat=args.remat,
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
        zero3=False,
    ).restrict_to(("data", "model"))
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    print(f"arch={cfg.name} params={api.param_count() / 1e6:.1f}M devices=1 device={api.device}")
    step_fn = build_train_step(api, plan, lr=args.lr, total_steps=args.steps)

    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start_step = restore_checkpoint(args.ckpt_dir, None, abstract_train_state(api, plan),
                                               device=api.device)
        print(f"restored checkpoint at step {start_step}")
    else:
        gen = torch.Generator(device=api.device).manual_seed(args.seed)
        state = init_train_state(api, gen, plan)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
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
            out.losses[step + 1] = float(metrics["loss"])
            out.grad_norms[step + 1] = float(metrics["grad_norm"])
            tokens_done += args.batch * args.seq
            if (step + 1) % args.log_every == 0 or step == start_step:
                dt = time.perf_counter() - t0  # det-lint: waive[wall-clock] reason=CLI report
                print(f"step {step + 1:5d} loss {out.losses[step + 1]:7.4f} grad_norm "
                      f"{out.grad_norms[step + 1]:8.3f} tok/s {tokens_done / dt:,.0f}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
    finally:
        loader.close()
        if ckpt:
            ckpt.close()
    if ckpt:
        print(f"final checkpoint at {args.ckpt_dir}")
    print("training done")
    return out


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
