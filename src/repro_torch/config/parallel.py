"""Parallelism / run configuration, and the card's constants.

Counterpart of ``repro.config.parallel``. ``ParallelPlan`` is the
reference's, copied: how logical tensor axes map onto mesh axes (the mesh
itself is not ported yet). ``HardwareSpec`` keeps the fields the
reference's cost models read (``peak_flops``, ``hbm_bandwidth``,
``ici_bandwidth``, ``hbm_bytes``) and, in place of the TPU's VMEM, the
card's own. ``H100_SXM`` is the one source of the H100's constants in the
port: the kernels' launch plans and ``chip_smoke.py``'s bounds read it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ParallelPlan:
    """Logical -> physical axis plan.

    Attributes:
      data_axes:    mesh axes used for batch data parallelism.
      fsdp_axes:    mesh axes over which parameters/optimizer state are
                    sharded ZeRO-3 style (all-gathered per layer on use).
      tensor_axes:  mesh axes for tensor (op) parallelism (heads / d_ff).
      expert_axes:  mesh axes for expert parallelism (MoE only).
      seq_axes:     mesh axes for sequence/context parallelism (long ctx).
      remat:        activation checkpoint policy: "none"|"full"|"dots".
      grad_accum:   microbatch count (1 = no accumulation).
      zero3:        shard params over fsdp_axes (else replicate over them).
      compress_grads: apply int8 error-feedback compression to the DP
                    gradient all-reduce (training only).
      overlap_weight_gather: double-buffer next-layer weight all-gather
                    inside the layer scan (ZeRO-3 prefetch).
    """

    data_axes: Tuple[str, ...] = ("pod", "data")
    fsdp_axes: Tuple[str, ...] = ("pod", "data")
    tensor_axes: Tuple[str, ...] = ("model",)
    expert_axes: Tuple[str, ...] = ("model",)
    seq_axes: Tuple[str, ...] = ("data",)
    remat: str = "full"
    grad_accum: int = 1
    zero3: bool = True
    compress_grads: bool = False
    overlap_weight_gather: bool = False

    def restrict_to(self, axis_names: Tuple[str, ...]) -> "ParallelPlan":
        """Drop mesh axes not present (e.g. no 'pod' on single-pod mesh)."""
        f = lambda axes: tuple(a for a in axes if a in axis_names)
        return ParallelPlan(
            data_axes=f(self.data_axes),
            fsdp_axes=f(self.fsdp_axes),
            tensor_axes=f(self.tensor_axes),
            expert_axes=f(self.expert_axes),
            seq_axes=f(self.seq_axes),
            remat=self.remat,
            grad_accum=self.grad_accum,
            zero3=self.zero3,
            compress_grads=self.compress_grads,
            overlap_weight_gather=self.overlap_weight_gather,
        )


@dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants of the target card (NVIDIA H100 SXM defaults).

    Every default is from NVIDIA's H100 data sheet,
    https://www.nvidia.com/en-us/data-center/h100/ (SXM part, dense rates
    without sparsity), which states the rates at the part's 700 W limit; a
    card set to a lower ``power.limit`` runs slower under load.
    """

    name: str = "h100-sxm"
    peak_flops: float = 989e12          # bf16 FLOP/s, tensor cores, dense
    hbm_bandwidth: float = 3.35e12      # bytes/s of HBM3
    ici_bandwidth: float = 900e9        # bytes/s of NVLink per card
    hbm_bytes: int = 80 * 10**9         # 80 GB of HBM3
    peak_flops_f32: float = 67e12       # float32 FLOP/s outside the tensor cores
    sm_count: int = 132                 # streaming multiprocessors
    l2_bytes: int = 50 * 10**6          # 50 MB of L2
    smem_bytes_per_sm: int = 228 * 1024  # 228 KB of shared memory per SM
    power_w: float = 700.0              # the power limit the rates assume


H100_SXM = HardwareSpec()
