"""The paper's Figure 3 application: distributed log processing.

Access -> HTTP(auth) -> FanOut -> HTTP(each shard, parallel) -> Render.
Shared by tests, benchmarks, and examples.

Counterpart of ``repro.apps.log_processing``, authored through the port's
declarative SDK (``repro_torch.sdk``): the three compute stages are typed
function declarations, the DAG is built from port-level dataflow
expressions (with ``sdk.each`` on the shard fetch), and the result compiles
to exactly the ``core/dag.py`` Composition the old hand-wired code
produced (the port's against the reference's: tests/test_torch_apps.py).
"""
from __future__ import annotations

from repro_torch import sdk
from repro_torch.core import (
    Composition,
    FunctionRegistry,
    HttpRequest,
    HttpResponse,
    Item,
    ServiceRegistry,
)


def log_processing_specs():
    """The three compute-stage declarations (access, fanout, render).
    The shard fan-out is data-driven (one fetch per URL in the auth
    response), so the specs don't depend on the shard count."""
    access = sdk.declare(
        "access",
        lambda ins: {"auth_req": [Item(HttpRequest(
            "GET", f"http://auth.svc/endpoints?tok={ins['token'][0].data}"))]},
        inputs=("token",), outputs=("auth_req",),
    )
    fanout = sdk.declare(
        "fanout",
        lambda ins: {"log_reqs": [
            Item(HttpRequest("GET", u), key=str(i))
            for i, u in enumerate(str(ins["endpoints"][0].data.body).split())
        ]},
        inputs=("endpoints",), outputs=("log_reqs",),
    )
    render = sdk.declare(
        "render",
        lambda ins: {"page": [Item(
            f"rendered {sum(len(str(i.data.body)) for i in ins['logs'])} bytes".encode()
        )]},
        inputs=("logs",), outputs=("page",),
    )
    return access, fanout, render


def log_processing_app() -> sdk.App:
    """The Figure 3 DAG as a declarative SDK application."""
    access, fanout, render = log_processing_specs()
    with sdk.composition("log_processing") as app:
        acc = access(token=app.input("token"))
        h1 = sdk.http("auth_call", requests=acc.auth_req)
        fan = fanout(endpoints=h1.responses)
        h2 = sdk.http("fetch_logs", requests=sdk.each(fan.log_reqs))
        ren = render(logs=h2.responses)
        app.output("result", ren.page)
    return app


def register_log_services(
    services: ServiceRegistry,
    *,
    shards: int = 3,
    log_bytes: int = 2000,
    auth_latency_s: float = 1e-3,
    shard_latency_s: float = 2e-3,
) -> None:
    """The auth endpoint plus one log-shard endpoint per shard."""
    hosts = [f"logs{i}.svc" for i in range(shards)]
    services.register(
        "auth.svc",
        lambda req: HttpResponse(200, " ".join(f"http://{h}/tail" for h in hosts)),
        base_latency_s=auth_latency_s,
    )
    blob = b"log-entry " * (log_bytes // 10)
    for h in hosts:
        services.register(
            h, lambda req, blob=blob: HttpResponse(200, blob),
            base_latency_s=shard_latency_s, bandwidth_bps=1e9,
        )


def build_log_processing(
    reg: FunctionRegistry,
    services: ServiceRegistry,
    *,
    shards: int = 3,
    log_bytes: int = 2000,
    auth_latency_s: float = 1e-3,
    shard_latency_s: float = 2e-3,
) -> Composition:
    """Legacy entry point: register services + functions + composition
    into explicit registries and return the IR. (SDK-native callers use
    ``log_processing_app`` with a ``sdk.Platform`` instead.)"""
    register_log_services(
        services, shards=shards, log_bytes=log_bytes,
        auth_latency_s=auth_latency_s, shard_latency_s=shard_latency_s,
    )
    app = log_processing_app()
    for spec in app.function_specs():
        spec.register_into(reg)
    return reg.register_composition(app.compile(reg))
