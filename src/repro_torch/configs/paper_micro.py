"""The paper's own workload configs (SS7 microbenchmarks).

Counterpart of ``repro.configs.paper_micro``, unchanged: pure data.

These are not LM architectures; they are the compute-function payloads used
by the Dandelion evaluation: the 128x128 int64 matmul (Fig. 2/6), the 1x1
matmul (Table 1 / Fig. 5), the fetch-and-reduce phase microbenchmark
(SS7.4), and the image-transform stand-in (SS7.6).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class MicroConfig:
    name: str
    matmul_n: int = 128          # square matmul dimension
    fetch_bytes: int = 64 * 1024  # SS7.4 phase fetch size
    phases: int = 8               # SS7.4 chain length
    image_kb: int = 18            # SS7.6 QOI image size


def matmul_1x1() -> MicroConfig:
    return MicroConfig(name="matmul_1x1", matmul_n=1)


def matmul_128() -> MicroConfig:
    return MicroConfig(name="matmul_128", matmul_n=128)


def fetch_compute(phases: int = 8) -> MicroConfig:
    return MicroConfig(name=f"fetch_compute_{phases}", phases=phases)


def image_compress() -> MicroConfig:
    return MicroConfig(name="image_compress")
