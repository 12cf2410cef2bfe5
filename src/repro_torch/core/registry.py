"""Function registry: compute-function binaries, code cache, compositions.

Compute functions are registered as python callables ``fn(inputs: SetDict)
-> SetDict`` plus an optional torch payload (``torch_fn``, a function of
tensors or an ``nn.Module``, with ``example_args`` tensors) that the
snapshot/microvm cold-start backends export or compile (the real code
paths those backends time - see repro_torch.core.coldstart).

Counterpart of ``repro.core.registry``; ``torch_fn`` and ``example_args``
stand where the reference has ``jax_fn`` and ``abstract_args``.

The registry models Dandelion's two-level code store: binaries live on
disk (pickle files) and may be cached in RAM. ``load_code(cached=False)``
does a real disk read + unpickle; ``cached=True`` a memcpy - the "load
from disk" row of Table 1.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.dag import (COMPUTE, SUBGRAPH, Composition,
                            fire_registration_hooks)
from repro_torch.core.items import SetDict, fingerprint_sets


@dataclass
class ComputeFunction:
    name: str
    fn: Callable[[SetDict], SetDict]
    context_bytes: int = 1 << 20
    # optional torch payload for the AOT cold-start backends: a function
    # of tensors or an nn.Module, and example tensors of its inputs
    torch_fn: Optional[Callable] = None
    example_args: Tuple[Any, ...] = ()
    # modeled execution time; None -> execute for real and measure
    service_time_s: Optional[float] = None
    idempotent: bool = True  # pure compute functions always are (SS6.1)
    memoize: bool = True     # pure fn: repeated inputs may reuse outputs
    # instances of this function may be coalesced with co-resident
    # instances into one modeled step on a node's batching engine
    # (continuous batching for serving decode steps; see
    # repro_torch.core.workloads.BatchStepModel). Platforms without batch
    # slots run batchable functions as ordinary compute tasks.
    batchable: bool = False
    disk_path: str = ""
    code: bytes = b""
    # declared purity opt-out (sdk.function(pure_unsafe=True)): the
    # analysis pass records it in the PurityReport instead of blocking
    pure_unsafe: bool = False


class PayloadMemo:
    """Content-addressed payload-execution cache (simulator fast path).

    Dandelion functions are pure (SS6.1): the same function body over the
    same input sets always produces the same output sets. When a task's
    *duration* comes from a calibrated ``ColdStartProfile`` (modeled
    virtual time), re-executing the real payload for every repeated trace
    event buys nothing — so each distinct ``(fn_name, input digest)``
    body runs once and later invocations reuse the outputs. Items are
    immutable, so sharing them is safe; output set lists are shallow-copied
    on both store and hit so callers can never mutate the cached entry.
    DAG dataflow stays byte-identical with the cache on or off (pinned by
    tests/test_sim_fastpath.py).

    Adaptive fingerprint bypass: hashing inputs is pure overhead for a
    function whose inputs never repeat (e.g. unique prompts in a serving
    trace), so after ``bypass_after`` consecutive misses with zero hits
    ever, the memo stops fingerprinting that function and executes its
    payload directly (counted in ``skips``). The rule is a deterministic
    function of the invocation history, and because payloads are pure
    and durations are modeled, skipping the cache never changes dataflow
    values or virtual timing — only the counters. One hit disables the
    bypass for that function permanently.
    """

    def __init__(self, capacity_entries: int = 65536, *,
                 bypass_after: int = 64):
        self.capacity_entries = capacity_entries
        self.bypass_after = bypass_after
        self._cache: "OrderedDict[Tuple[str, str], SetDict]" = OrderedDict()
        # per-function [hits, consecutive misses] for the adaptive bypass
        self._fn_stats: Dict[str, list] = {}
        self.hits = 0
        self.misses = 0
        self.skips = 0   # unfingerprintable inputs, memoize=False fns,
                         # or adaptive bypass

    def run(self, cf: ComputeFunction, inputs: SetDict) -> SetDict:
        """Execute ``cf`` over ``inputs`` through the cache."""
        if not cf.memoize:
            self.skips += 1
            return cf.fn(inputs)
        st = self._fn_stats.get(cf.name)
        if st is None:
            st = [0, 0]
            self._fn_stats[cf.name] = st
        elif st[0] == 0 and st[1] >= self.bypass_after:
            self.skips += 1
            return cf.fn(inputs)
        fp = fingerprint_sets(inputs)
        if fp is None:
            self.skips += 1
            return cf.fn(inputs)
        key = (cf.name, fp)
        cached = self._cache.get(key)
        if cached is not None:
            self.hits += 1
            st[0] += 1
            self._cache.move_to_end(key)
            return {name: list(items) for name, items in cached.items()}
        self.misses += 1
        st[1] += 1
        out = cf.fn(inputs)
        self._cache[key] = {name: list(items) for name, items in out.items()}
        while len(self._cache) > self.capacity_entries:
            self._cache.popitem(last=False)
        return out

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._cache)


class FunctionRegistry:
    def __init__(self, code_dir: Optional[str] = None, *, memoize: bool = True):
        self.code_dir = code_dir or tempfile.mkdtemp(prefix="dandelion_code_")
        self.functions: Dict[str, ComputeFunction] = {}
        self.compositions: Dict[str, Composition] = {}
        self._ram_cache: Dict[str, bytes] = {}
        # payload-execution memo for modeled-duration tasks; None disables
        self.memo: Optional[PayloadMemo] = PayloadMemo() if memoize else None

    # ------------------------------------------------------- functions
    def register_function(
        self,
        name: str,
        fn: Callable[[SetDict], SetDict],
        *,
        context_bytes: int = 1 << 20,
        torch_fn: Optional[Callable] = None,
        example_args: Tuple[Any, ...] = (),
        service_time_s: Optional[float] = None,
        memoize: bool = True,
        batchable: bool = False,
        pure_unsafe: bool = False,
    ) -> ComputeFunction:
        try:
            code = pickle.dumps(fn)
        except Exception:
            # closures/compiled callables aren't picklable; store a stub of
            # representative size (the bytes still flow through the real
            # disk/cache code paths).
            code = pickle.dumps(name.encode() * 64)
        path = os.path.join(self.code_dir, f"{name}.bin")
        with open(path, "wb") as f:
            f.write(code)
        cf = ComputeFunction(
            name=name,
            fn=fn,
            context_bytes=context_bytes,
            torch_fn=torch_fn,
            example_args=example_args,
            service_time_s=service_time_s,
            memoize=memoize,
            batchable=batchable,
            disk_path=path,
            code=code,
            pure_unsafe=pure_unsafe,
        )
        self.functions[name] = cf
        return cf

    def run_payload(self, name: str, inputs: SetDict) -> SetDict:
        """Execute a function body, reusing memoized outputs for repeated
        input digests (valid only when the caller models the duration —
        the virtual-time fast path must not short-circuit measured runs)."""
        cf = self.get(name)
        if self.memo is not None:
            return self.memo.run(cf, inputs)
        return cf.fn(inputs)

    def get(self, name: str) -> ComputeFunction:
        if name not in self.functions:
            raise KeyError(f"unregistered compute function {name!r}")
        return self.functions[name]

    def load_code(self, name: str, cached: bool) -> bytes:
        """Real code-load path: RAM cache memcpy or disk read + unpickle."""
        cf = self.get(name)
        if cached and name in self._ram_cache:
            return bytes(self._ram_cache[name])  # copy, like a memcpy
        with open(cf.disk_path, "rb") as f:
            raw = f.read()
        try:
            pickle.loads(raw)
        except Exception:
            pass
        self._ram_cache[name] = raw
        return raw

    def code_size(self, name: str) -> int:
        """Binary size in bytes without performing the real load (the
        modeled fast path commits code memory by size only)."""
        return len(self.get(name).code)

    def evict(self, name: str) -> None:
        self._ram_cache.pop(name, None)

    # ---------------------------------------------------- compositions
    def register_composition(self, comp: Composition) -> Composition:
        """Validate and store a composition. Beyond the structural
        ``Composition.validate`` checks, every compute vertex (including
        nested subgraphs) must reference a registered function — a typo'd
        ``function=`` name fails here, naming the vertex, instead of at
        invoke time."""
        comp.validate()
        self._check_functions(comp)
        # analysis seam: lint hooks (repro_torch.core.dag.add_registration_hook)
        # see every structurally-valid composition before it is stored —
        # a strict hook raises and the registration never lands
        fire_registration_hooks(comp)
        self.compositions[comp.name] = comp
        return comp

    def _check_functions(self, comp: Composition) -> None:
        for v in comp.vertices.values():
            if v.kind == COMPUTE and v.function not in self.functions:
                raise ValueError(
                    f"{comp.name}: compute vertex {v.name!r} references "
                    f"unregistered function {v.function!r}"
                )
            if v.kind == SUBGRAPH and v.subgraph is not None:
                self._check_functions(v.subgraph)

    def get_composition(self, name: str) -> Composition:
        if name not in self.compositions:
            raise KeyError(f"unregistered composition {name!r}")
        return self.compositions[name]
