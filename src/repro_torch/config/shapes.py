"""Assigned input-shape sets and (arch x shape) applicability rules.

Counterpart of ``repro.config.shapes``, copied: ``TRAIN_4K`` is the shape
of the training path (``training/``), the others the serving cells.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.config.model import ModelConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicability(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return None if (arch, shape) runs, else a skip reason string.

    Rules from the assignment:
      * ``long_500k`` needs sub-quadratic attention -> skip for pure
        full-attention archs, run for SSM / hybrid.
      * encoder-only archs have no decode step (none of ours are
        encoder-only; whisper is enc-dec and does decode).
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return (
            "full-attention arch: 524288-token context is quadratic; "
            "skipped per assignment (see DESIGN.md SS4)"
        )
    if shape.kind == "decode" and not cfg.has_decoder:
        return "encoder-only arch has no decode step"
    return None


def runnable_cells(cfgs):
    """Yield (cfg, shape, skip_reason) for the full 40-cell grid."""
    for cfg in cfgs:
        for name in SHAPE_ORDER:
            shape = SHAPES[name]
            yield cfg, shape, applicability(cfg, shape)
