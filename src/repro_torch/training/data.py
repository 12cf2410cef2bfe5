"""Synthetic data pipeline with background prefetch.

Counterpart of ``repro.training.data``. There are no datasets: a batch is
pseudo-random tokens drawn from ``np.random.SeedSequence([seed, step])``
with the reference's draws, in its order, so both packages see the same
bytes for a step and a restart from a checkpoint resumes the exact stream.
Batches are numpy arrays; ``to_device`` moves one onto the card. A
prefetch thread assembles the next batches while the device computes.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.config.shapes import ShapeConfig


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, *, batch_override: int = 0,
               seq_override: int = 0, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch for ``step``."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
    batch: Dict[str, np.ndarray] = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_frames, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model), dtype=np.float32)
    return batch


def to_device(batch: Dict[str, np.ndarray], device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A ``make_batch`` batch as tensors on ``device``: the token arrays int32, the
    frames or patches in the model's ``dtype``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device=device, dtype=torch.int32 if v.dtype == np.int32 else dtype)
        for k, v in batch.items()}


class PrefetchingLoader:
    """Iterator of (step, batch) that materializes batches on a background thread."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, start_step: int = 0,
                 num_steps: Optional[int] = None, batch_override: int = 0, seq_override: int = 0,
                 seed: int = 0, prefetch: int = 2):
        self.cfg, self.shape = cfg, shape
        self.start_step = start_step
        self.num_steps = num_steps
        self.batch_override = batch_override
        self.seq_override = seq_override
        self.seed = seed
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.start_step
        while not self._stop.is_set():
            if self.num_steps is not None and step >= self.start_step + self.num_steps:
                self._q.put(None)
                return
            batch = make_batch(self.cfg, self.shape, step, batch_override=self.batch_override,
                               seq_override=self.seq_override, seed=self.seed)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        """Stop the thread: drain the queue so that a blocked ``put`` returns, then join."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
