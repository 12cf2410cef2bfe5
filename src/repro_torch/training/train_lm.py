"""Train a ~100M-parameter LM with the fault-tolerance loop: ``examples/train_lm.py``
on the port.

Async checkpoints, a simulated crash, and an exact resume from the latest
checkpoint. Each training phase runs as a declarative-SDK compute function,
``train_phase`` (``memoize=False``, ``pure_unsafe=True``: it writes the
checkpoint directory), invoked through a one-node ``sdk.Platform``: the
front door that ``serving/serve_lm.py`` serves through, here carrying a
training payload that runs on the card.

    python -m repro_torch.training.train_lm --steps 200                 # the card
    python -m repro_torch.training.train_lm --steps 20 --device cpu     # the CPU
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from typing import Dict, Optional, Sequence

import torch

from repro_torch import sdk
from repro_torch.config import ModelConfig
from repro_torch.config.parallel import ParallelPlan
from repro_torch.config.shapes import ShapeConfig
from repro_torch.core import Item
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import build
from repro_torch.training.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.training.data import make_batch, to_device
from repro_torch.training.train_step import (abstract_train_state, build_train_step,
                                             init_train_state)


def hundred_m_config() -> ModelConfig:
    """~100M-parameter llama-style config (GPT-2-small scale)."""
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=10, d_model=640,
        num_heads=10, num_kv_heads=10, d_ff=1792, vocab_size=32000,
        head_dim=64, tie_embeddings=True,
    )


def run(steps: int, batch: int, seq: int, ckpt_dir: str, crash_at: Optional[int] = None,
        lr: float = 3e-4, log_every: Optional[int] = None, ckpt_every: Optional[int] = None,
        device: str = "cuda"):
    """Train from the latest checkpoint under ``ckpt_dir`` (or from seed 0) to
    ``steps``; stop after step ``crash_at`` once its checkpoints are written.
    Returns (the state, or None after a crash; {step: loss} every ``log_every``)."""
    log_every = log_every or max(1, min(20, steps // 5))
    ckpt_every = ckpt_every or max(1, min(50, steps // 4))
    cfg = hundred_m_config()
    api = build(cfg, device=device)
    plan = ParallelPlan(remat="none", zero3=False).restrict_to(())
    shape = ShapeConfig("train", seq_len=seq, global_batch=batch, kind="train")
    step_fn = build_train_step(api, plan, lr=lr, warmup_steps=20, total_steps=steps)

    start = 0
    if latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(ckpt_dir, None, abstract_train_state(api, plan),
                                          device=api.device)
        print(f"  resumed from checkpoint at step {start}")
    else:
        state = init_train_state(api, torch.Generator(device=api.device).manual_seed(0), plan)
        print(f"  fresh start ({api.param_count() / 1e6:.1f}M params)")

    ckpt = AsyncCheckpointer(ckpt_dir, keep=2)
    losses: Dict[int, float] = {}
    for i in range(start, steps):
        b = to_device(make_batch(cfg, shape, i), api.device, torch_dtype(cfg.dtype))
        state, metrics = step_fn(state, b)
        if (i + 1) % log_every == 0:
            losses[i + 1] = float(metrics["loss"])
            print(f"  step {i + 1:4d} loss {losses[i + 1]:.4f}")
        if (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, state)
        if crash_at is not None and i + 1 == crash_at:
            ckpt.wait()
            print(f"  !! simulated crash at step {crash_at}")
            ckpt.close()
            return None, losses
    ckpt.close()
    return state, losses


@sdk.function(inputs=("cmd",), outputs=("report",), memoize=False,
              timeout_s=7 * 86400.0,  # effectively unlimited, like a direct run() call
              # knowingly impure: run() writes checkpoints and progress to stdout —
              # real training, not a modeled payload
              pure_unsafe=True)
def train_phase(ins):
    """One training phase as a platform payload: config in, loss report out.
    Crash/resume state lives in the checkpoint directory."""
    cmd = json.loads(ins["cmd"][0].data)
    state, losses = run(**cmd)
    return {"report": [Item(json.dumps({
        "completed": state is not None,
        "losses": {str(k): v for k, v in losses.items()},
    }))]}


def train_app() -> sdk.App:
    with sdk.composition("train_lm") as app:
        phase = train_phase(cmd=app.input("cmd"))
        app.output("report", phase.report)
    return app


def invoke_phase(platform: sdk.Platform, app: sdk.App, **cmd) -> dict:
    """Run one ``train_phase`` with ``cmd`` (``run``'s keywords) through
    ``platform``; its report."""
    handle = platform.invoke(app, {"cmd": [Item(json.dumps(cmd))]})
    return json.loads(handle.result()["report"][0].data)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_ckpt_")

    app = train_app()
    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=2, comm_slots=1))
    platform.deploy(app)

    base = dict(steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=ckpt_dir,
                device=args.device)
    crash_at = max(1, min(args.steps // 2, 100))
    print(f"phase 1: train to step {crash_at}, then crash")
    invoke_phase(platform, app, crash_at=crash_at, **base)

    print("phase 2: restart from the latest checkpoint and finish")
    report = invoke_phase(platform, app, **base)
    if not report["completed"]:
        raise RuntimeError("phase 2 did not complete")
    losses = {int(k): v for k, v in report["losses"].items()}
    if losses:
        print(f"final loss {losses[max(losses)]:.4f} "
              f"(from {losses[min(losses)]:.4f} at step {min(losses)})")
    if not args.ckpt_dir:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
