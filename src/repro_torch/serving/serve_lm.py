"""LM serving as a Dandelion composition on one ``WorkerNode``.

The generation call of ``examples/serve_lm.py`` (lines 54-87 there), on
``repro_torch.core`` until the SDK is ported: one compute function,
``generate``, submits one ``Request`` to a ``ContinuousBatcher`` and runs
it to completion; a composition ``serve_lm`` has that one vertex, prompt
in, tokens out. ``generate`` is registered with ``memoize=False`` and
``pure_unsafe=True`` (it drives the stateful batcher) and without a
profile, so the node runs it for real and bills its measured time, the
card synchronised on both sides (``core.engines``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import Composition, FunctionRegistry, Item, WorkerNode
from repro_torch.core.dispatcher import InvocationRun
from repro_torch.serving.batching import ContinuousBatcher, Request


def serve_lm_app(batcher: ContinuousBatcher,
                 max_new_tokens: int) -> Tuple[FunctionRegistry, Composition]:
    """The registry holding ``generate`` over ``batcher``, and ``serve_lm``.
    Prompts and tokens travel as int32 bytes; request ids count from 1."""
    rid_counter = [0]

    def generate_fn(inputs):
        prompt = np.frombuffer(inputs["prompt"][0].data, np.int32).tolist()
        rid_counter[0] += 1
        rid = rid_counter[0]
        batcher.submit(Request(rid, prompt, max_new_tokens=max_new_tokens))
        out = batcher.run_to_completion()[rid]
        return {"tokens": [Item(np.asarray(out, np.int32).tobytes())]}

    reg = FunctionRegistry()
    reg.register_function("generate", generate_fn, context_bytes=8 << 20, memoize=False,
                          pure_unsafe=True)
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


def tokens_of(run: InvocationRun) -> List[int]:
    """The generated tokens of one ``serve_lm`` run."""
    return np.frombuffer(run.outputs["tokens"][0].data, np.int32).tolist()
