"""End-to-end serving CLI: batched requests through the continuous-batching LM
engine.

Counterpart of ``repro.launch.serve``, with its flags and defaults, plus
``--device`` (the card unless the caller asks for the CPU; no fallback).
Random weights from ``--seed``; prompts of 4-24 tokens from
``numpy.random.default_rng(seed)``, as the reference draws them. A request's
frames (encdec) or patches (vlm) are zeros of the model's own shapes: the
reference passes 16 frames, which whisper's cross cache of
``cfg.encoder_frames`` slots cannot take, and sends a vlm through a batcher
that cannot serve one (ROADMAP C). Here ``--cache-len`` counts text slots;
a vlm's batcher adds ``cfg.num_patches`` slots for its patches.

    python -m repro_torch.launch.serve --arch granite-8b                # the card, full width
    python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch.specs import extras_for
from repro_torch.models.model import build
from repro_torch.serving.batching import ContinuousBatcher, Request


class Served(NamedTuple):
    results: Dict[int, List[int]]   # request id -> generated tokens
    seconds: float                  # wall time from the first submit to the last token


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def prompts(cfg, args) -> List[List[int]]:
    """The requests' prompts, drawn as the reference draws them."""
    host = np.random.default_rng(args.seed)
    out = []
    for _ in range(args.requests):
        plen = int(host.integers(4, min(24, args.cache_len)))
        out.append(host.integers(0, cfg.vocab_size, plen).tolist())
    return out


def request_extras(cfg, device) -> Dict[str, torch.Tensor]:
    """One request's prefill keywords: zero frames [1, encoder_frames, D] or
    patches [1, num_patches, D] in the model's dtype; {} for the other families."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in extras_for(cfg, 1).items()}


def run(args, params=None) -> Served:
    """Serve ``args.requests`` prompts; ``params`` (random from ``args.seed`` if
    None) must be on ``args.device`` and fit the CLI's config."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg, device=args.device)
    if params is None:
        params = api.init_params(torch.Generator(device=api.device).manual_seed(args.seed))
    print(f"arch={cfg.name} params={api.param_count() / 1e6:.1f}M device={api.device}")

    extra = request_extras(cfg, api.device)
    batcher = ContinuousBatcher(api, params, num_slots=args.slots,
                                cache_len=args.cache_len + cfg.num_patches,
                                extras_fn=lambda rid: extra)
    t0 = time.perf_counter()  # det-lint: waive[wall-clock] reason=CLI report of real serving
    for rid, prompt in enumerate(prompts(cfg, args)):
        batcher.submit(Request(rid, prompt, max_new_tokens=args.max_new))
    results = batcher.run_to_completion()
    if api.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0  # det-lint: waive[wall-clock] reason=CLI report of real serving
    return Served(results, dt)


def main(argv: Optional[Sequence[str]] = None) -> Served:
    served = run(parser().parse_args(argv))
    results, dt = served.results, served.seconds
    total_tokens = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid][:10]}")
    return served


if __name__ == "__main__":
    main()
