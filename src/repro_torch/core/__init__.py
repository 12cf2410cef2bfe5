"""Dandelion core: the paper's contribution as a composable platform.

Programming model (SS4): ``Composition`` DAGs of pure compute functions +
platform communication functions, with all/each/key edge fan-out.

Execution system (SS5-6): memory contexts, dispatcher, compute/comm
engines, PI slot controller, cold-start backends, one worker node.

Counterpart of ``repro.core``: the same names, except those of the
modules not ported yet (``artifacts``, ``cluster``, ``control_plane``).
"""
from repro_torch.core.coldstart import (
    BACKENDS,
    CodeCache,
    ColdStartBreakdown,
    ColdStartProfile,
    TransferProfile,
    cold_start,
    measure,
    profile_from_measurement,
)
from repro_torch.core.context import MemoryContext, MemoryTracker
from repro_torch.core.dag import Composition, Edge, PortRef, Vertex
from repro_torch.core.dispatcher import Dispatcher, InvocationRun
from repro_torch.core.engines import EngineSet, Task
from repro_torch.core.http import (
    HttpRequest,
    HttpResponse,
    SanitizationError,
    ServiceRegistry,
    sanitize,
)
from repro_torch.core.items import Item, ItemSet, SetDict, fingerprint_sets, make_set
from repro_torch.core.node import WorkerNode
from repro_torch.core.registry import FunctionRegistry, PayloadMemo
from repro_torch.core.sim import EventLoop, ShardedEventLoop, Timeline, merged_peak
from repro_torch.core.tracing import (
    LatencyStats,
    LinkCounters,
    NodeCounters,
    RoutingStats,
    ThroughputStats,
    TransferStats,
)
from repro_torch.core.workloads import BatchStepModel, WeightStore

__all__ = [
    "BACKENDS",
    "BatchStepModel",
    "CodeCache",
    "ColdStartBreakdown",
    "ColdStartProfile",
    "Composition",
    "Dispatcher",
    "Edge",
    "EngineSet",
    "EventLoop",
    "ShardedEventLoop",
    "FunctionRegistry",
    "HttpRequest",
    "HttpResponse",
    "InvocationRun",
    "Item",
    "ItemSet",
    "LatencyStats",
    "LinkCounters",
    "MemoryContext",
    "MemoryTracker",
    "NodeCounters",
    "PayloadMemo",
    "PortRef",
    "RoutingStats",
    "ThroughputStats",
    "SanitizationError",
    "ServiceRegistry",
    "SetDict",
    "Task",
    "Timeline",
    "TransferProfile",
    "TransferStats",
    "Vertex",
    "WeightStore",
    "WorkerNode",
    "cold_start",
    "fingerprint_sets",
    "make_set",
    "measure",
    "merged_peak",
    "profile_from_measurement",
    "sanitize",
]
