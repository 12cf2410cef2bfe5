"""Parameter templates, initialisation and device handling.

Models declare their parameters as nested dicts (and lists, for the
encoder-decoder's blocks) of ``ParamSpec`` (shape, logical axes, initializer,
dtype), as the JAX package does; ``init_params`` materialises the same tree
of tensors. The tree's leaves are addressed by ``/``-joined paths
(``blocks/attn/wq``, ``dec_blocks/0/self_attn/wq``), the same paths the JAX
package's trees have.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | embed | ssm_a
    dtype: Optional[str] = None  # None -> model default

    def with_layers(self, num_layers: int) -> "ParamSpec":
        return ParamSpec(
            (num_layers,) + self.shape, ("layers",) + self.axes, self.init, self.dtype
        )


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32}[name]


def _children(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``/``-joined path, leaf) pairs of nested dicts and lists, in order; a list
    item's key is its index (``dec_blocks/0/self_attn/wq``)."""
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The same nested dicts and lists with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # all but the last dim are fan-in (the [in, out] convention)
    return int(np.prod(shape[:-1]))


def _truncated_normal_(out: torch.Tensor, generator: torch.Generator) -> None:
    """Standard normal truncated to [-2, 2], by inverting the CDF of a uniform."""
    cdf_hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0   # Phi(2); Phi(-2) = 1 - Phi(2)
    out.uniform_(1.0 - 2.0 * cdf_hi, 2.0 * cdf_hi - 1.0, generator=generator)
    out.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def init_params(template, generator: torch.Generator, device="cuda",
                dtype: str = "bfloat16"):
    """Materialise ``template``: deterministic given the generator's state.

    One seed is drawn from ``generator``; each leaf then gets its own
    generator seeded from it and from the crc32 of the leaf's path, so adding
    a parameter does not change the others. Normal leaves are fan-in scaled
    truncated normals, ``embed`` is N(0, 0.02), ``ssm_a`` (Mamba2's A_log) is
    log(U[1, 16]) drawn in float32, ``ones``/``zeros`` are constants. Layer-stacked leaves are drawn one layer at a time, which
    keeps the float32 scratch to one layer.
    """
    dev = resolve_device(device)
    base = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device).item())

    def make(path: str, spec: ParamSpec) -> torch.Tensor:
        dt = torch_dtype(spec.dtype or dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed((base * 1_000_003 + zlib.crc32(path.encode())) % 2**63)
        arr = torch.empty(spec.shape, dtype=dt, device=dev)
        stacked = spec.axes[:1] == ("layers",)
        for part in (arr.unbind(0) if stacked else (arr,)):
            tmp = torch.empty(part.shape, dtype=torch.float32, device=dev)
            if spec.init == "embed":
                tmp.normal_(0.0, 0.02, generator=gen)
            elif spec.init == "ssm_a":
                tmp.uniform_(1.0, 16.0, generator=gen).log_()
            else:  # fan-in scaled truncated normal
                _truncated_normal_(tmp, gen)
                tmp.mul_(1.0 / math.sqrt(max(1, _fan_in(spec.shape))))
            part.copy_(tmp)
        return arr

    return tree_map_with_path(make, template)


def empty_tree(spec, device="cuda", dtype: str = "bfloat16"):
    """A cache from its ParamSpec tree: zeros, int32 leaves of rank >= 3 (``slot_pos``)
    -1 (empty), other int32 leaves (``pos``) 0; leaves whose spec names no dtype
    take ``dtype``."""
    dev = resolve_device(device)

    def mk(s: ParamSpec) -> torch.Tensor:
        dt = torch_dtype(s.dtype or dtype)
        if s.dtype == "int32":
            return torch.full(s.shape, -1 if len(s.shape) >= 3 else 0, dtype=dt, device=dev)
        return torch.zeros(s.shape, dtype=dt, device=dev)

    return tree_map(mk, spec)


def param_count(template) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_items(template))


def param_bytes(template, default_dtype: str = "bfloat16") -> int:
    return sum(
        int(np.prod(s.shape)) * torch_dtype(s.dtype or default_dtype).itemsize
        for _, s in tree_items(template)
    )
