"""Data model for function I/O: items grouped into named sets.

An Item is an immutable (key, data) pair; data is ``bytes`` or a numpy
array or torch tensor (arrays move through memory contexts without
serialization - the analogue of Dandelion's memory-mapped input sets).
Keys are only used by 'key'-mode edge grouping, exactly as in the paper
(SS4.1).

Counterpart of ``repro.core.items``: bytes, str, scalars and numpy arrays
hash byte for byte as there, so the same items have the same fingerprints
in both packages. A torch tensor is opaque (``_data_bytes`` gives None),
as a device array is in the reference: hashing a CUDA tensor would copy it
to the host on every invocation.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class Item:
    data: Any
    key: str = ""

    # items are immutable, so both the size and the content digest are
    # computed once per item and cached (frozen dataclasses still carry a
    # __dict__, which is what cached_property writes into)
    @cached_property
    def nbytes(self) -> int:
        d = self.data
        if isinstance(d, (bytes, bytearray)):
            return len(d)
        if hasattr(d, "nbytes"):
            return int(d.nbytes)
        if isinstance(d, str):
            return len(d.encode())
        return 64  # opaque python object: nominal

    @cached_property
    def content_fp(self) -> Optional[bytes]:
        """16-byte digest of (key, data), or None when the data is opaque
        and offers no ``fingerprint()`` hook. Cached so an item flowing
        through several consumers (or repeated invocations of the same
        composition) is hashed exactly once."""
        enc = _data_bytes(self.data)
        if enc is None:
            return None
        h = hashlib.blake2b(digest_size=16)
        k = self.key.encode()
        h.update(len(k).to_bytes(8, "little"))
        h.update(k)
        h.update(len(enc).to_bytes(8, "little"))
        h.update(enc)
        return h.digest()


ItemSet = List[Item]
SetDict = Dict[str, ItemSet]


def make_set(*values, keys: Optional[List[str]] = None) -> ItemSet:
    keys = keys or [""] * len(values)
    return [Item(v, k) for v, k in zip(values, keys)]


def set_bytes(s: ItemSet) -> int:
    return sum(it.nbytes for it in s)


def sets_bytes(d: SetDict) -> int:
    return sum(set_bytes(s) for s in d.values())


def group_by_key(s: ItemSet) -> Dict[str, ItemSet]:
    out: Dict[str, ItemSet] = {}
    for it in s:
        out.setdefault(it.key, []).append(it)
    return out


# ---------------------------------------------------------------------------
# Content fingerprints (payload-execution memoization, see registry.PayloadMemo)
# ---------------------------------------------------------------------------
def _data_bytes(d: Any) -> Optional[bytes]:
    """Canonical byte encoding of item data for hashing, or None when the
    payload is an opaque object we cannot fingerprint safely (memoization
    is then skipped for the whole invocation)."""
    if isinstance(d, (bytes, bytearray)):
        return b"b:" + bytes(d)
    if isinstance(d, str):
        return b"s:" + d.encode()
    if isinstance(d, bool):
        return b"B:%d" % d
    if isinstance(d, int):
        return b"i:" + repr(d).encode()
    if isinstance(d, float):
        return b"f:" + repr(d).encode()
    if d is None:
        return b"n:"
    if isinstance(d, np.ndarray):
        if d.dtype.hasobject:
            return None  # tobytes() would hash PyObject pointers
        return b"a:" + str(d.dtype).encode() + repr(d.shape).encode() + d.tobytes()
    # opaque objects may opt in to memoization by providing a
    # ``fingerprint()`` method returning a stable str/bytes content id
    # (e.g. apps.inference_service.KVCache) — the memoized-decode contract
    fp = getattr(d, "fingerprint", None)
    if callable(fp):
        out = fp()
        if isinstance(out, str):
            out = out.encode()
        if isinstance(out, (bytes, bytearray)):
            return b"o:" + type(d).__name__.encode() + b":" + bytes(out)
    return None


def fingerprint_sets(d: SetDict) -> Optional[str]:
    """Content digest of a SetDict: set names, item order, keys, and data.
    Returns None (caller must execute for real) if any item holds data we
    cannot canonically encode — arbitrary python objects without a
    ``fingerprint()`` hook, device arrays. Set names are length-framed and
    per-item digests are fixed-width, so payload bytes can never masquerade
    as field boundaries (no collisions by concatenation)."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(d):
        nb = name.encode()
        h.update(b"\x00")
        h.update(len(nb).to_bytes(8, "little"))
        h.update(nb)
        for it in d[name]:
            fp = it.content_fp
            if fp is None:
                return None
            h.update(b"\x01")
            h.update(fp)
    return h.hexdigest()
