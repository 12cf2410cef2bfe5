"""Dandelion core: the paper's contribution as a composable platform.

Programming model (SS4): ``Composition`` DAGs of pure compute functions +
platform communication functions, with all/each/key edge fan-out.

Execution system (SS5-6): memory contexts, dispatcher, compute/comm
engines, PI control plane, cold-start backends, cluster manager.

Counterpart of ``repro.core``: the same names, less the exporters that only
the reference's own benchmarks read (``ThroughputStats``, and in
``core.tracing`` ``StreamingPercentile`` and ``LiveTelemetry``).
"""
from repro_torch.core.artifacts import (
    Artifact,
    ArtifactCatalog,
    P2PDistributor,
    PrefetchConfig,
)
from repro_torch.core.cluster import ClusterManager, CrossNodePlacer, KeepWarmPlatform
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
from repro_torch.core.control_plane import (
    BatchRouter,
    BurstPredictor,
    ControlPlaneConfig,
    ElasticControlPlane,
    PredictorConfig,
    ReplicaAutoscaler,
    ReplicaConfig,
    composition_batch_units,
    composition_functions,
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
    TransferStats,
)
from repro_torch.core.workloads import BatchStepModel, WeightStore

__all__ = [
    "Artifact",
    "ArtifactCatalog",
    "BACKENDS",
    "BatchRouter",
    "BatchStepModel",
    "BurstPredictor",
    "ClusterManager",
    "CodeCache",
    "ColdStartBreakdown",
    "ColdStartProfile",
    "Composition",
    "ControlPlaneConfig",
    "CrossNodePlacer",
    "ElasticControlPlane",
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
    "KeepWarmPlatform",
    "LatencyStats",
    "ReplicaAutoscaler",
    "ReplicaConfig",
    "LinkCounters",
    "MemoryContext",
    "MemoryTracker",
    "NodeCounters",
    "P2PDistributor",
    "PayloadMemo",
    "PortRef",
    "PredictorConfig",
    "PrefetchConfig",
    "RoutingStats",
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
    "composition_batch_units",
    "composition_functions",
    "fingerprint_sets",
    "make_set",
    "measure",
    "merged_peak",
    "profile_from_measurement",
    "sanitize",
]
