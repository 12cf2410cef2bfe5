"""Serving cost models: roofline terms and the model-weight cold start.

Counterpart of the serving half of ``repro.launch.hlo_analysis``:
``RooflineTerms``, ``WeightColdStart``, ``weight_coldstart_estimate`` and
``serving_step_terms``, with the reference's arithmetic. The reference
counts the instructions of an optimized HLO module (``count_hlo_ops``) as
its compile-time proxy; the port has no HLO, and counts the operator calls
of a ``torch.export`` program instead (``count_graph_ops``), the artifact
the snapshot cold-start backend builds (``core/coldstart.py``).

The collective half of the reference's module (``parse_collectives``,
``CollectiveStats``) reads the collectives of an SPMD-partitioned HLO
module. Its counterpart counts the collectives of the sharded steps
(``serving.engine.jit_serve_steps``, ``training.train_step.jit_train_step``)
on ``launch.mesh.make_production_mesh``, where ``torch.distributed``'s
``CommDebugMode`` takes the place of the HLO; it is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class RooflineTerms:
    """Three-term roofline for one step.

    All *_s values are seconds for one step execution on the target HW.
    FLOPs and bytes are per device; global = per_device x chips.
    """

    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_link_bytes_per_device: float
    collective_operand_bytes_per_device: float
    peak_flops: float
    hbm_bw: float
    ici_bw: float
    model_flops: float = 0.0  # 6*N*D useful-compute reference

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_link_bytes_per_device / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        if self.model_flops <= 0:
            return 0.0
        return self.model_flops / (self.flops_per_device * self.chips)

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x roofline step time)."""
        t = self.step_time_s
        if t <= 0 or self.model_flops <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def to_json(self) -> dict:
        return {
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_link_bytes_per_device": self.collective_link_bytes_per_device,
            "collective_operand_bytes_per_device": self.collective_operand_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
        }


# ===========================================================================
# Serving cost models (serving-on-Dandelion: weight cold start + step terms)
# ===========================================================================
def count_graph_ops(exported) -> int:
    """Operator calls (``call_function`` nodes) of a ``torch.export``
    ``ExportedProgram``: the compile-time proxy ``weight_coldstart_estimate``
    consumes, in place of the reference's HLO instruction count."""
    return sum(1 for node in exported.graph.nodes if node.op == "call_function")


@dataclass(frozen=True)
class WeightColdStart:
    """Model-weight cold-start terms for a serving function.

    The FaaSNet observation (PAPERS.md): for inference functions the
    dominant provisioning cost is not the sandbox but moving and
    preparing the model — reading ``param_bytes`` from the code store
    (disk / object storage) plus (re)building the executable, priced
    from its operation count (``hlo_ops``, the reference's name). ``total_s``
    feeds the function's ``ColdStartProfile.cold_setup_s``, charged only
    when the executing node does not already hold the weights
    (``core.workloads.WeightStore``).
    """

    param_bytes: float
    disk_bandwidth_bps: float = 2e9        # NVMe-class read rate
    hlo_ops: int = 0
    compile_s_per_op: float = 2e-3         # compile cost per operation

    @property
    def load_s(self) -> float:
        return self.param_bytes / self.disk_bandwidth_bps

    @property
    def compile_s(self) -> float:
        return self.hlo_ops * self.compile_s_per_op

    @property
    def total_s(self) -> float:
        return self.load_s + self.compile_s


def weight_coldstart_estimate(
    param_bytes: float,
    *,
    exported=None,
    hlo_ops: Optional[int] = None,
    disk_bandwidth_bps: float = 2e9,
    compile_s_per_op: float = 2e-3,
) -> WeightColdStart:
    """Build a ``WeightColdStart`` from either a real ``torch.export`` program
    (``exported``, counted with ``count_graph_ops``) or a caller-supplied
    op-count estimate (e.g. layers x ops-per-layer for configs too big to
    export on this host)."""
    ops = count_graph_ops(exported) if exported is not None else int(hlo_ops or 0)
    return WeightColdStart(
        param_bytes=param_bytes,
        disk_bandwidth_bps=disk_bandwidth_bps,
        hlo_ops=ops,
        compile_s_per_op=compile_s_per_op,
    )


def serving_step_terms(
    *,
    param_bytes: float,
    flops_per_seq: float,
    kv_bytes_per_seq: float,
    batch: int,
    peak_flops: float,
    hbm_bw: float,
    ici_bw: float = 1.0,
    chips: int = 1,
) -> RooflineTerms:
    """Roofline terms for ONE decode (or prefill) step over ``batch``
    co-resident sequences on one replica: each sequence adds its own
    FLOPs and KV traffic while the weight read is paid once per step —
    the amortization continuous batching exists to exploit. The
    ``step_time_s`` of the returned terms is what the platform's
    ``core.workloads.BatchStepModel`` reproduces as ``step_s(batch)``
    (minus the per-step overhead floor the platform adds)."""
    return RooflineTerms(
        chips=chips,
        flops_per_device=batch * flops_per_seq,
        hbm_bytes_per_device=param_bytes + batch * kv_bytes_per_seq,
        collective_link_bytes_per_device=0.0,
        collective_operand_bytes_per_device=0.0,
        peak_flops=peak_flops,
        hbm_bw=hbm_bw,
        ici_bw=ici_bw,
        model_flops=batch * flops_per_seq,
    )
