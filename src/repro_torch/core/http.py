"""Communication functions: HTTP protocol handling + service models.

The container is offline, so remote services are in-process handlers
behind deterministic latency/bandwidth models (DESIGN.md SS2). The
*protocol* work is real: requests are parsed and sanitized exactly as the
paper's communication engine does (SS6.3) - method and version checked
against fixed sets, host extracted and validated - and handlers produce
real payloads that flow on through the composition.
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.items import Item, ItemSet, SetDict

METHODS = ("GET", "PUT", "POST", "DELETE", "HEAD", "PATCH")
# floor on modeled protocol-handling CPU per request (the old measured
# path clamped real perf_counter deltas to this)
MIN_COMM_CPU_S = 2e-6
IDEMPOTENT_METHODS = ("GET", "PUT", "DELETE", "HEAD")
_VERSIONS = ("HTTP/1.0", "HTTP/1.1", "HTTP/2")
_HOST_RE = re.compile(
    r"^(?:[a-zA-Z0-9](?:[a-zA-Z0-9\-]{0,61}[a-zA-Z0-9])?)"
    r"(?:\.[a-zA-Z0-9](?:[a-zA-Z0-9\-]{0,61}[a-zA-Z0-9])?)*$"
)
_IP_RE = re.compile(r"^\d{1,3}(?:\.\d{1,3}){3}$")


@dataclass(frozen=True)
class HttpRequest:
    method: str
    url: str
    body: Any = b""

    @property
    def host(self) -> str:
        m = re.match(r"^https?://([^/:]+)", self.url)
        return m.group(1) if m else ""

    @property
    def nbytes(self) -> int:
        if isinstance(self.body, (bytes, bytearray)):
            return len(self.body)
        if hasattr(self.body, "nbytes"):
            return int(self.body.nbytes)
        return len(str(self.body).encode())


@dataclass(frozen=True)
class HttpResponse:
    status: int
    body: Any = b""

    @property
    def nbytes(self) -> int:
        if isinstance(self.body, (bytes, bytearray)):
            return len(self.body)
        if hasattr(self.body, "nbytes"):
            return int(self.body.nbytes)
        return len(str(self.body).encode())


class SanitizationError(ValueError):
    pass


def sanitize(req: Any) -> HttpRequest:
    """Untrusted-input validation (SS6.3): method + version from fixed
    sets; host must be a valid name or IPv4 literal."""
    if isinstance(req, HttpRequest):
        method, url = req.method, req.url
        parsed = req
    elif isinstance(req, (str, bytes)):
        text = req.decode() if isinstance(req, bytes) else req
        first = text.split("\r\n", 1)[0].split("\n", 1)[0]
        parts = first.strip().split()
        if len(parts) == 3:
            method, url, version = parts
            if version not in _VERSIONS:
                raise SanitizationError(f"bad HTTP version {version!r}")
        elif len(parts) == 2:
            method, url = parts
        else:
            raise SanitizationError(f"malformed request line {first!r}")
        body = text.split("\r\n\r\n", 1)[1] if "\r\n\r\n" in text else b""
        parsed = HttpRequest(method, url, body)
    else:
        raise SanitizationError(f"unsupported request type {type(req).__name__}")
    if method not in METHODS:
        raise SanitizationError(f"method {method!r} not allowed")
    host = parsed.host
    if not host or not (_HOST_RE.match(host) or _IP_RE.match(host)):
        raise SanitizationError(f"invalid host {host!r}")
    return parsed


@dataclass
class ServiceModel:
    """One remote endpoint: handler + latency/bandwidth/CPU models.

    Protocol-handling CPU is *modeled*, not measured: real wall-clock
    timing of the in-process handler leaked host jitter into virtual
    time, making comm-task durations vary run to run. The model is a
    per-service base cost (seeded deterministically from the host name
    at registration) plus a parse/copy cost per wire byte."""

    handler: Callable[[HttpRequest], HttpResponse]
    base_latency_s: float = 0.5e-3
    bandwidth_bps: float = 1.25e9  # 10 Gb/s
    cpu_base_s: float = MIN_COMM_CPU_S
    cpu_per_byte_s: float = 0.2e-9  # ~5 GB/s header/body parse + memcpy

    def io_time(self, req: HttpRequest, resp: HttpResponse) -> float:
        wire = req.nbytes + resp.nbytes
        return self.base_latency_s + wire / self.bandwidth_bps

    def cpu_time(self, req: HttpRequest, resp: HttpResponse) -> float:
        wire = req.nbytes + resp.nbytes
        return max(self.cpu_base_s + wire * self.cpu_per_byte_s,
                   MIN_COMM_CPU_S)


def _service_cpu_base(host: str) -> float:
    """Deterministic per-service protocol CPU base cost: +/-25% around
    MIN_COMM_CPU_S*2, seeded from the host name (stable across runs and
    processes, unlike hash())."""
    u = (zlib.crc32(host.encode()) % 1024) / 1024.0
    return 2 * MIN_COMM_CPU_S * (0.75 + 0.5 * u)


class ServiceRegistry:
    """host -> ServiceModel. Shared by all communication engines."""

    def __init__(self):
        self.services: Dict[str, ServiceModel] = {}

    def register(
        self,
        host: str,
        handler: Callable[[HttpRequest], HttpResponse],
        *,
        base_latency_s: float = 0.5e-3,
        bandwidth_bps: float = 1.25e9,
        cpu_base_s: Optional[float] = None,
    ) -> None:
        self.services[host] = ServiceModel(
            handler, base_latency_s, bandwidth_bps,
            cpu_base_s=_service_cpu_base(host) if cpu_base_s is None
            else cpu_base_s,
        )

    def perform(self, req: HttpRequest) -> Tuple[HttpResponse, float, float]:
        """Execute the request. Returns (response, modeled io seconds,
        modeled protocol-handling cpu seconds)."""
        svc = self.services.get(req.host)
        if svc is None:
            return HttpResponse(502, b"no route to host"), 1e-3, MIN_COMM_CPU_S
        resp = svc.handler(req)
        return resp, svc.io_time(req, resp), svc.cpu_time(req, resp)


def http_function(
    services: ServiceRegistry, inputs: SetDict
) -> Tuple[SetDict, float, float, bool]:
    """The platform HTTP communication function body.

    Sanitizes every request item, performs them (serially within one
    instance - parallelism is expressed with 'each' fan-out in the DAG),
    and returns (outputs, total io seconds, total modeled cpu seconds,
    idempotent_all). CPU cost is modeled per service so comm-task virtual
    durations are deterministic run to run.
    """
    responses: ItemSet = []
    io_total = 0.0
    cpu_total = 0.0
    idempotent = True
    for it in inputs.get("requests", []):
        req = sanitize(it.data)  # raises SanitizationError on bad input
        idempotent &= req.method in IDEMPOTENT_METHODS
        resp, io_s, cpu_s = services.perform(req)
        io_total += io_s
        cpu_total += cpu_s
        responses.append(Item(resp, key=it.key))
    return {"responses": responses}, io_total, max(cpu_total, MIN_COMM_CPU_S), idempotent
