"""LM serving as a Dandelion composition: ``examples/serve_lm.py`` on the port.

One compute function, ``generate``, submits one ``Request`` to a
``ContinuousBatcher`` and runs it to completion; a composition ``serve_lm``
has that one vertex, prompt in, tokens out. ``generate`` is declared with
``memoize=False`` and ``pure_unsafe=True`` (it drives the stateful batcher
and a closed-over request counter) and without a profile, so a node runs
it for real and bills its measured time, the card synchronised on both
sides (``core.engines``).

Two spellings of the same composition:

  * ``serve_lm_sdk_app`` / ``serve_on_platform``: through ``repro_torch.sdk``
    (``sdk.declare`` + ``sdk.composition``), on any ``sdk.Platform`` shape:
    one node, a pool, or an elastic cluster. This is the example's;
  * ``serve_lm_app`` / ``serve_on_node``: on the core API, a registry and a
    ``WorkerNode`` built by hand.

    python -m repro_torch.serving.serve_lm --arch granite-8b          # the card, full width
    python -m repro_torch.serving.serve_lm --arch olmoe-1b-7b --device cpu   # CPU, smoke config
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sdk
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import Composition, FunctionRegistry, Item, WorkerNode
from repro_torch.core.dispatcher import InvocationRun
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import build
from repro_torch.serving.batching import ContinuousBatcher, Request


def _generate_fn(batcher: ContinuousBatcher, max_new_tokens: int) -> Callable[[Dict], Dict]:
    """The ``generate`` payload over ``batcher``: prompts and tokens travel as
    int32 bytes; request ids count from 1."""
    rid_counter = [0]

    def generate_fn(inputs):
        prompt = np.frombuffer(inputs["prompt"][0].data, np.int32).tolist()
        rid_counter[0] += 1
        rid = rid_counter[0]
        batcher.submit(Request(rid, prompt, max_new_tokens=max_new_tokens))
        out = batcher.run_to_completion()[rid]
        return {"tokens": [Item(np.asarray(out, np.int32).tobytes())]}

    return generate_fn


def serve_lm_sdk_app(batcher: ContinuousBatcher, max_new_tokens: int) -> sdk.App:
    """``serve_lm`` through the SDK, as ``examples/serve_lm.py`` declares it."""
    generate = sdk.declare(
        "generate", _generate_fn(batcher, max_new_tokens), inputs=("prompt",),
        outputs=("tokens",), context_bytes=8 << 20, memoize=False,
        # knowingly impure: drives the stateful continuous batcher and a
        # closed-over request counter — real serving, not a modeled payload
        pure_unsafe=True,
    )
    with sdk.composition("serve_lm") as app:
        g = generate(prompt=app.input("prompt"))
        app.output("tokens", g.tokens)
    return app


def serve_on_platform(batcher: ContinuousBatcher, prompts: Sequence[Sequence[int]],
                      max_new_tokens: int, platform: sdk.Platform, *,
                      app: Optional[sdk.App] = None) -> List[sdk.InvocationHandle]:
    """Deploy ``serve_lm`` on ``platform``, invoke it once per prompt, request i
    at i ms of virtual time, and run the platform; returns the handles in
    request order. ``app`` is a ``serve_lm_sdk_app`` over ``batcher`` to deploy
    (the same app may go to several platforms); None builds one."""
    app = app if app is not None else serve_lm_sdk_app(batcher, max_new_tokens)
    platform.deploy(app)
    handles = [platform.invoke(app, {"prompt": [Item(np.asarray(p, np.int32).tobytes())]},
                               at=i * 1e-3)
               for i, p in enumerate(prompts)]
    platform.run()
    return handles


def serve_lm_app(batcher: ContinuousBatcher,
                 max_new_tokens: int) -> Tuple[FunctionRegistry, Composition]:
    """The registry holding ``generate`` over ``batcher``, and ``serve_lm``, on
    the core API."""
    reg = FunctionRegistry()
    reg.register_function("generate", _generate_fn(batcher, max_new_tokens),
                          context_bytes=8 << 20, memoize=False, pure_unsafe=True)
    app = Composition("serve_lm")
    g = app.compute("generate", "generate", inputs=("prompt",), outputs=("tokens",),
                    context_bytes=8 << 20)
    app.bind_input("prompt", g["prompt"])
    app.bind_output("tokens", g["tokens"])
    reg.register_composition(app)
    return reg, app


def serve_on_node(batcher: ContinuousBatcher, prompts: Sequence[Sequence[int]],
                  max_new_tokens: int, *, num_slots: int = 4,
                  comm_slots: int = 1) -> Tuple[WorkerNode, List[InvocationRun]]:
    """Invoke ``serve_lm`` once per prompt, request i at i ms of virtual
    time, and run the node; returns it and the runs in request order."""
    reg, app = serve_lm_app(batcher, max_new_tokens)
    node = WorkerNode(reg, num_slots=num_slots, comm_slots=comm_slots)
    runs: List[InvocationRun] = [None] * len(prompts)
    for i, prompt in enumerate(prompts):
        node.invoke_at(i * 1e-3, app, {"prompt": [Item(np.asarray(prompt, np.int32).tobytes())]},
                       on_done=lambda inv, i=i: runs.__setitem__(i, inv))
    node.run()
    return node, runs


def tokens_of(run) -> List[int]:
    """The generated tokens of one ``serve_lm`` run or handle."""
    return np.frombuffer(run.outputs["tokens"][0].data, np.int32).tolist()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``examples/serve_lm.py`` on the port: the full config on the card, or
    the smoke config with ``--device cpu``; random weights from seed 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = (get_smoke if args.device == "cpu" else get_config)(args.arch)
    api = build(cfg, device=args.device)
    params = api.init_params(torch.Generator(device=args.device).manual_seed(0))
    print(f"arch={cfg.name} ({api.param_count() / 1e6:.1f}M params) on {api.device}")

    key, length = {"vlm": ("patches", cfg.num_patches),
                   "encdec": ("frames", cfg.encoder_frames)}.get(cfg.family, (None, 0))
    extra = ({} if key is None else
             {key: torch.zeros((1, length, cfg.d_model), dtype=torch_dtype(cfg.dtype),
                               device=api.device)})
    # the example's 32 text slots; a vlm's patches take slots of their own
    batcher = ContinuousBatcher(api, params, num_slots=args.slots,
                                cache_len=32 + cfg.num_patches, extras_fn=lambda rid: extra)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12))).tolist()
               for _ in range(args.requests)]
    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=4, comm_slots=1))
    t0 = time.perf_counter()  # det-lint: waive[wall-clock] reason=CLI report; the wall is printed, not modeled
    handles = serve_on_platform(batcher, prompts, args.max_new, platform)
    wall = time.perf_counter() - t0  # det-lint: waive[wall-clock] reason=CLI report

    ok = [h for h in handles if h.done]
    toks = sum(len(tokens_of(h)) for h in ok)
    print(f"served {len(ok)}/{args.requests} requests, {toks} tokens, "
          f"{wall:.2f}s wall ({toks / wall:.1f} tok/s)")
    print("platform latency (virtual):",
          {k: round(v, 3) for k, v in platform.latency.summary().items()})
    for h in ok[:3]:
        print("  ->", tokens_of(h))


if __name__ == "__main__":
    main()
