"""Checkpoints in the reference's format, with an async background writer.

Counterpart of ``repro.training.checkpoint``; a checkpoint written by
either package restores in the other. One directory per step:

    <dir>/step_000123/
        manifest.json     # step, leaves {name: {key, shape, dtype}}, shard hashes
        shard_00000.npz   # leaf_00000 ... as numpy arrays; bf16 as a uint16 view

Leaf names are the reference's ``_flatten_with_names`` paths of the same
tree (``params/blocks/attn/wq``, ``opt/step``, ``opt/mu/...``,
``residual/residual/...``): a NamedTuple's fields in order, a dict's keys
sorted (as ``jax.tree_util`` orders them), a list's indices, ``None`` no
leaf. Writes go to ``<step dir>.tmp``, the manifest is fsync'd, then the
directory is renamed, so a crash never leaves a half checkpoint that looks
whole; every shard's sha256[:16] is checked before a restore uses it.
``AsyncCheckpointer.save`` copies the tensors to host memory before it
returns and writes them on its thread. A sharded state (DTensor leaves) is
saved whole: ``host_tree`` gathers every leaf, which is a collective, so
every rank calls it and one rank writes; a restore gives whole tensors,
whatever world wrote them.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), x) for i, x in enumerate(tree)]


def flatten_with_names(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of every leaf, in ``jax.tree_util``'s order, named as the
    reference's ``_flatten_with_names`` names them."""
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for key, child in _children(tree):
            yield from flatten_with_names(child, f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, tree


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree``'s structure with ``leaf_fn(name, leaf)`` at each leaf."""
    if tree is None:
        return None
    name = lambda key: f"{prefix}/{key}" if prefix else str(key)
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_fn, name(f)) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, name(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, name(i)) for i, v in enumerate(tree))
    return leaf_fn(prefix, tree)


@dataclass(frozen=True)
class _Host:
    """A leaf copied to host memory: its array, bf16 as the uint16 bits."""
    array: np.ndarray
    bf16: bool


def _host(t) -> _Host:
    if isinstance(t, _Host):
        return t
    if not isinstance(t, torch.Tensor):
        return _Host(np.asarray(t), False)
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return _Host(t.view(torch.int16).numpy().view(np.uint16), True)
    return _Host(t.numpy(), False)


def host_tree(tree):
    """``tree`` with every tensor copied, whole, to host memory (a DTensor leaf
    gathered: every rank of its mesh calls this)."""
    return _rebuild(tree, lambda _, t: _host(t))


def _hash_bytes(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Synchronous save of ``tree`` (tensors, or a ``host_tree``). Returns the path."""
    ckpt = os.path.join(directory, f"step_{step:08d}")
    tmp = ckpt + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for i, (name, leaf) in enumerate(flatten_with_names(tree)):
        host = _host(leaf)
        key = f"leaf_{i:05d}"
        arrays[key] = host.array
        manifest["leaves"][name] = {"key": key, "shape": list(host.array.shape),
                                    "dtype": "bfloat16" if host.bf16 else str(host.array.dtype)}
    shard_path = os.path.join(tmp, "shard_00000.npz")
    np.savez(shard_path, **arrays)
    with open(shard_path, "rb") as f:
        manifest["shards"] = {"shard_00000.npz": _hash_bytes(f.read())}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)
    return ckpt


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int], template, device="cuda"):
    """(tree, step): the checkpoint of ``step`` (None: the latest) in
    ``template``'s structure, every leaf a tensor on ``device`` with the dtype
    and shape the manifest records. Raises ``IOError`` if a shard's hash
    disagrees with the manifest's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    for fname, want in manifest["shards"].items():
        with open(os.path.join(ckpt, fname), "rb") as f:
            got = _hash_bytes(f.read())
        if got != want:
            raise IOError(f"checkpoint shard {fname} corrupt: {got} != {want}")
    dev = resolve_device(device)
    with np.load(os.path.join(ckpt, "shard_00000.npz")) as data:
        def load(name, _):
            meta = manifest["leaves"][name]
            raw = data[meta["key"]]
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(np.ascontiguousarray(raw).view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(raw.astype(meta["dtype"])))
            return t.reshape(meta["shape"]).to(dev)

        return _rebuild(template, load), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer (overlaps I/O with training)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save_checkpoint(self.directory, step, tree)
                self._gc()
            except BaseException as e:  # surfaced on the next save or wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))

    def save(self, step: int, tree):
        """Copy ``tree`` to host memory now; write it to disk in the background."""
        if self._err:
            raise self._err
        self._q.put((step, host_tree(tree)))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()
