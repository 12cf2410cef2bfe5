"""The Dandelion declarative SDK: the typed front door to the platform.

The paper's programming model (SS4.1) is *declarative* — applications
are DAGs of pure compute functions and platform communication functions.
This package makes that the user-facing surface:

  1. **typed function declaration** — ``@sdk.function`` /
     ``sdk.declare`` / ``sdk.ref`` capture every ``ComputeFunction``
     metadata field at the definition site (``repro_torch.sdk.functions``);
  2. **declarative composition building** — port-level dataflow
     expressions with ``each``/``key`` fan-out sugar, HTTP comm
     vertices, nested compositions, and eager validation that names the
     offending vertex/edge (``repro_torch.sdk.builder``); compiles to the
     ``repro_torch.core.dag:Composition`` IR unchanged;
  3. **the Platform facade** — one object owning registries, the event
     loop, and a single/pool/elastic execution backend, with a unified
     ``deploy`` / ``invoke -> InvocationHandle`` / ``submit_stream``
     API (``repro_torch.sdk.platform``).

Minimal application:

    from repro_torch import sdk
    from repro_torch.core import Item

    @sdk.function(inputs=("doc",), outputs=("stats",))
    def word_count(ins):
        n = len(ins["doc"][0].data.body.split())
        return {"stats": [Item(f"words={n}".encode())]}

    with sdk.composition("quickstart") as app:
        fetch = sdk.http("fetch", requests=app.input("request"))
        count = word_count(_name="count", doc=fetch.responses)
        app.output("stats", count.stats)

    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=4))
    platform.deploy(app)
    print(platform.invoke(app, {"request": [...]}).result())

Error taxonomy in ``repro_torch.sdk.errors``; full reference in docs/API.md.

Counterpart of ``repro.sdk``: the same names and behaviour over
``repro_torch.core``; a declaration's torch payload is ``torch_fn`` with
``example_args`` (the reference's ``jax_fn`` / ``abstract_args``).
"""
from repro_torch.core.artifacts import PrefetchConfig
from repro_torch.core.coldstart import ColdStartProfile, TransferProfile
from repro_torch.core.control_plane import (
    BatchRouter,
    ControlPlaneConfig,
    PredictorConfig,
    ReplicaConfig,
)
from repro_torch.core.dag import RetryPolicy
from repro_torch.core.http import HttpRequest, HttpResponse
from repro_torch.core.items import Item
from repro_torch.core.workloads import BatchStepModel, WeightStore
from repro_torch.sdk.builder import (
    App,
    InputRef,
    Port,
    VertexHandle,
    composition,
    each,
    http,
    key,
    single_function_app,
)
from repro_torch.sdk.errors import (
    DeclarationError,
    DeploymentError,
    InvocationFailed,
    PurityError,
    SDKError,
    UnknownPortError,
    ValidationError,
    WiringError,
)
from repro_torch.sdk.config import DEPRECATED_ENV_ALIASES, PlatformConfig
from repro_torch.sdk.functions import FunctionSpec, declare, function, ref
from repro_torch.sdk.platform import Elastic, InvocationHandle, NodeSpec, Platform
from repro_torch.sdk.verify import verify
from repro_torch.analysis import PurityReport

__all__ = [
    # declaration
    "FunctionSpec",
    "declare",
    "function",
    "ref",
    # composition building
    "App",
    "InputRef",
    "Port",
    "VertexHandle",
    "composition",
    "each",
    "http",
    "key",
    "single_function_app",
    # platform
    "DEPRECATED_ENV_ALIASES",
    "Elastic",
    "InvocationHandle",
    "NodeSpec",
    "Platform",
    "PlatformConfig",
    "PredictorConfig",
    "PrefetchConfig",
    # verification
    "verify",
    "PurityReport",
    # errors
    "DeclarationError",
    "DeploymentError",
    "InvocationFailed",
    "PurityError",
    "SDKError",
    "UnknownPortError",
    "ValidationError",
    "WiringError",
    # convenience re-exports (core types SDK apps touch constantly)
    "BatchRouter",
    "BatchStepModel",
    "ColdStartProfile",
    "ControlPlaneConfig",
    "ReplicaConfig",
    "HttpRequest",
    "HttpResponse",
    "Item",
    "RetryPolicy",
    "TransferProfile",
    "WeightStore",
]
