"""Continuous batching: slot-based scheduler over a shared decode cache.

Counterpart of ``repro.serving.batching``, with its scheduling kept exactly:
requests are admitted FIFO into the lowest free slot, prefilled one at a
time (batch-1), the first token is taken from the prefill logits, the
request's cache is written into its slot, and then every slot, empty ones
included, is decoded together once per token. Finished slots are freed
immediately.

The reference pads every prompt to the cache length. Here a prompt is padded
to ``prefill_length``: the next multiple of ``PREFILL_QUANTUM`` positions,
capped at the cache, on a grid where every real token sees what it sees
padded to the cache. ``insert_slot`` then writes the prefilled span of the
slot and marks the rest of its ``slot_pos`` empty. ``prefill_prompt_tokens``
over ``prefill_positions`` is the share of the prefilled positions that were
prompt.

Spans (``core.tracing``): ``batcher.step`` holds ``batcher.admit`` (one
``batcher.prefill``, up to the host's read of the first token, and one
``batcher.insert_slot`` a request), ``batcher.decode`` (the tokens' copy to the
device until the host holds the next ones) and ``batcher.emit``.

``extras_fn(rid)`` gives a request's prefill keywords (``frames=`` for an
encdec model, ``patches=`` for a vlm), as in the reference. A vlm's
``cfg.num_patches`` patches take P of the cache's slots (P is 0 for the other
families), so its text is cut to cache_len - P, the room ``prefill_length``
is given, and its prefill cache has P + that length's slots. The reference
pads the text to cache_len, so its vlm prefill cache has cache_len + P slots
and cannot be written into the batched cache.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import tracing
from repro_torch.models.common import tree_items
from repro_torch.models.model import ModelApi
from repro_torch.models.transformer import MOE_GROUP


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: int = -1
    arrival: float = 0.0
    # filled by the scheduler
    generated: List[int] = field(default_factory=list)
    done: bool = False
    first_token_at: float = 0.0  # time.perf_counter() when the first token was known


PREFILL_QUANTUM = 256   # positions: a prefill's length is a multiple of it, or the cache's room


def prefill_length(n: int, room: int, cfg: ModelConfig) -> int:
    """The positions a prompt of ``n`` tokens is prefilled at, out of the ``room``
    that the cache has for text (cache_len - P).

    The smallest multiple of ``PREFILL_QUANTUM`` that holds the prompt, capped at
    ``room``, on the grid where the padded positions change nothing for the real
    ones: a MoE layer routes in groups of ``min(MOE_GROUP, S)`` with a capacity per
    group, so where ``room`` exceeds a group the length is a multiple of the group,
    and otherwise it is ``room``; the tokens of a group are ranked in order, so the
    padding after a prompt takes only the capacity the prompt leaves. A hybrid's
    sliding ring has min(window, S) slots, as many as the cache's sliding leaves
    only at a length of at least min(window, room). An SSM's state and ``pos``
    do not depend on the length."""
    step = PREFILL_QUANTUM
    if cfg.family == "moe":
        if room <= MOE_GROUP:
            return room
        step = MOE_GROUP
    length = min(-(-max(n, 1) // step) * step, room)
    if cfg.family == "hybrid" and cfg.sliding_window:
        length = max(length, min(cfg.sliding_window, room))
    return length


def _axes(api: ModelApi, batch: int, cache_len: int, name: str) -> Dict[str, Optional[int]]:
    """For each cache leaf path, the index of its dim ``name`` (from logical axes)."""
    return {path: (s.axes.index(name) if name in s.axes else None)
            for path, s in tree_items(api.cache_spec(batch, cache_len))}


def _batch_axes(api: ModelApi, batch: int, cache_len: int) -> Dict[str, Optional[int]]:
    """For each cache leaf path, the index of its batch dim (from logical axes)."""
    return _axes(api, batch, cache_len, "batch")


def insert_slot(cache, one, slot: int, batch_axes: Dict[str, Optional[int]],
                seq_axes: Optional[Dict[str, Optional[int]]] = None) -> None:
    """Write a batch-1 cache tree into ``slot`` of the batched cache, in place.

    A leaf with a ``cache_seq`` dim (``seq_axes``) takes the prefill's b positions
    into the slot's first b, and the rest of the slot's ``slot_pos`` is set to -1,
    so that what an earlier request left there reads as empty; K/V past b keep
    stale values, which ``slot_pos`` masks. Other leaves are copied whole."""
    flat_one = dict(tree_items(one))
    for path, c in tree_items(cache):
        bax = batch_axes[path]
        if bax is None:
            continue
        dst, src = c.narrow(bax, slot, 1), flat_one[path]
        sax = seq_axes.get(path) if seq_axes else None
        if sax is not None:
            b = src.shape[sax]
            if path.endswith("slot_pos"):
                dst.narrow(sax, b, dst.shape[sax] - b).fill_(-1)
            dst = dst.narrow(sax, 0, b)
        dst.copy_(src)  # copy_ casts to the cache's dtype


class ContinuousBatcher:
    """Iteration-level scheduler. Host-side control, device-side steps, on
    the device the ``api`` was built for."""

    def __init__(self, api: ModelApi, params, *, num_slots: int, cache_len: int,
                 extras_fn: Optional[Callable[[int], Dict[str, torch.Tensor]]] = None):
        self.api = api
        self.params = params
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.extras_fn = extras_fn  # rid -> dict of prefill keyword tensors
        self.device = api.device
        self.cache = api.init_cache(num_slots, cache_len)
        self.batch_axes = _batch_axes(api, num_slots, cache_len)
        self.seq_axes = _axes(api, num_slots, cache_len, "cache_seq")
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.cur_tokens = np.zeros((num_slots,), np.int32)
        self.waiting: List[Request] = []
        self._steps = 0
        self.all_requests: List[Request] = []
        # prompt tokens prefilled, and the text positions the prefills were handed
        self.prefill_prompt_tokens = 0
        self.prefill_positions = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.waiting.append(req)
        self.all_requests.append(req)

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def steps(self) -> int:
        """Decode steps run so far."""
        return self._steps

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self):
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.waiting.pop(0)
            kw = {k: v.to(self.device) for k, v in
                  (self.extras_fn(req.rid) if self.extras_fn else {}).items()}
            room = self.cache_len - self.api.cfg.num_patches
            prompt = req.prompt[:room]
            length = prefill_length(len(prompt), room, self.api.cfg)
            self.prefill_prompt_tokens += len(prompt)
            self.prefill_positions += length
            with tracing.span("batcher.prefill"):
                tokens = torch.tensor([prompt + [0] * (length - len(prompt))], dtype=torch.int32,
                                      device=self.device)
                plens = torch.tensor([len(prompt)], dtype=torch.int32, device=self.device)
                logits, one_cache = self.api.prefill(self.params, tokens, plens, **kw)
                first = int(torch.argmax(logits[0]))  # waits for the prefill
            # det-lint: waive[wall-clock] reason=real serving; the time to first token is measured, not modeled
            req.first_token_at = time.perf_counter()
            with tracing.span("batcher.insert_slot"):
                insert_slot(self.cache, one_cache, slot, self.batch_axes, self.seq_axes)
            self.slots[slot] = req
            req.generated.append(first)
            self.cur_tokens[slot] = first
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        if len(req.generated) >= req.max_new_tokens or (
            req.eos_id >= 0 and req.generated and req.generated[-1] == req.eos_id
        ):
            req.done = True
            self.slots[slot] = None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> List[Tuple[int, int]]:
        """Admit waiting requests, run one decode step, emit (rid, token)."""
        with tracing.span("batcher.step"):
            with tracing.span("batcher.admit"):
                self._admit()
            if self.active == 0:
                return []
            with tracing.span("batcher.decode"):
                tokens = torch.tensor(self.cur_tokens, device=self.device)
                logits, self.cache = self.api.decode_step(self.params, self.cache, tokens)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            out = []
            with tracing.span("batcher.emit"):
                for i, req in enumerate(self.slots):
                    if req is None:
                        continue
                    tok = int(nxt[i])
                    req.generated.append(tok)
                    self.cur_tokens[i] = tok
                    out.append((req.rid, tok))
                    self._maybe_finish(i)
            self._steps += 1
            return out

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.waiting and self.active == 0:
                break
            self.step()
        return {req.rid: req.generated for req in self.all_requests}
