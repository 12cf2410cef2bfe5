"""Carry weights (and any other tree of arrays) from numpy into the port.

The JAX package's parameter tree, given as nested dicts and lists of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), becomes the port's
tree: the same nesting, so the same ``/``-joined leaf paths
(``blocks/attn/wq``, ``dec_blocks/0/self_attn/wq``), with layer-stacked
leaves kept ``[L, ...]`` and matrices kept ``[in, out]``. Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import resolve_device, tree_map


def to_tensor(arr: Any, device="cuda") -> torch.Tensor:
    """One numpy array (or array-like) to a tensor of the same dtype.

    ``np.asarray`` of a JAX bfloat16 array has the ``ml_dtypes`` dtype
    ``bfloat16``, which ``torch.from_numpy`` rejects; its bits are read as
    uint16 and reinterpreted as ``torch.bfloat16``.
    """
    arr = np.array(arr)  # a writable, contiguous copy the tensor may own
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def from_numpy_tree(tree, device="cuda"):
    """Nested dicts and lists of numpy arrays -> the same nesting of tensors."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor to numpy, bfloat16 widened to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
