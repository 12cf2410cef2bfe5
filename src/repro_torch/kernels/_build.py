"""Build the CUDA sources under ``repro_torch/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` at the
repository root, compiled by ``nvcc`` for ``sm_90a`` at first use. The hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header builds anew and an unchanged one is loaded from the
cache. All sources are compiled together,
one ``nvcc`` process each. The libraries have a plain C interface: every
entry takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` as an int, which the wrappers turn into an exception.

Nothing here runs at import: the CPU tests import every module, on machines
that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, out, b, sq, sk, hq, hkv, dh, scale, causal, window, stream
_FLASH = (_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _P)
# q, k, v, slot_pos, cur_pos, out, float32 workspace, b, s, hq, hkv, dh, scale, window,
# nsplit, split_slots, stream
_DECODE = (_P,) * 7 + (_I,) * 5 + (_F, _I, _I, _I, _P)
# C signature of every entry point, by library.
SIGNATURES = {
    "rmsnorm": {
        # x, scale, out, rows, d, eps, stream
        "rmsnorm_f32": (_P, _P, _P, _I, _I, _F, _P),
        "rmsnorm_bf16": (_P, _P, _P, _I, _I, _F, _P),
    },
    "decode_attention": {
        "decode_attention_f32": _DECODE,
        "decode_attention_bf16": _DECODE,
        "decode_attention_f32q_bf16kv": _DECODE,  # float32 q against a bf16 cache, bf16 out
    },
    "flash_attention": {
        "flash_attention_f32": _FLASH,
        "flash_attention_bf16": _FLASH,
        "flash_attention_bf16_wgmma": _FLASH,  # bf16 on the tensor cores, head_dim 64 or 128
    },
    "moe_gmm": {
        # xe, we, live (int32 [E, G] or null), out, e, rows, groups, d, f, stream
        "moe_gmm_f32": (_P,) * 4 + (_I,) * 5 + (_P,),
        # ... and the tile plan (rows per wgmma, wgmmas per row tile) before the stream
        "moe_gmm_bf16": (_P,) * 4 + (_I,) * 7 + (_P,),
    },
    "ssd": {
        # x, a, b, c, y, h_final, float32 workspaces (chunk states, C·Bᵀ, chunk decays),
        # b, s, h, p, n, chunk, stream
        "ssd_f32": (_P,) * 9 + (_I,) * 6 + (_P,),
        "ssd_bf16": (_P,) * 9 + (_I,) * 6 + (_P,),
    },
}


@dataclass
class BuildRecord:
    name: str
    path: Path
    cached: bool          # True: loaded a library built earlier
    seconds: float        # nvcc wall time (0 on a cache hit)


_libs: Dict[str, ctypes.CDLL] = {}
records: Dict[str, BuildRecord] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    """The cached library of ``csrc/<name>.cu``: keyed on the source, every shared
    header (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, BuildRecord]:
    """Compile every library that is not cached yet, all ``nvcc``s at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        if name in records:
            continue
        target = _target(name)
        if target.exists():
            records[name] = BuildRecord(name, target, True, 0.0)
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter(), tmp, target)
    failures = []
    for name, (proc, t0, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        if verbose and log.strip():
            print(log.strip())
        os.replace(tmp, target)  # atomic: a concurrent loader sees no half-written file
        records[name] = BuildRecord(name, target, False, seconds)
    if failures:
        raise RuntimeError("\n".join(failures))
    return records


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if name not in records:
            build_all()
        lib = ctypes.CDLL(str(records[name].path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(ok: bool, what: str) -> None:
    """Raise on an input the kernel does not take."""
    if not ok:
        raise ValueError(what)


def check_inputs(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Every tensor is a contiguous tensor on ``device``, which is the current CUDA device."""
    require(device.type == "cuda", f"{name}: the kernel takes CUDA tensors, got {device}")
    require(device.index is None or device.index == torch.cuda.current_device(),
            f"{name}: tensors on {device}, current CUDA device is {torch.cuda.current_device()}")
    for arg, t in tensors.items():
        require(t.device == device, f"{name}: {arg} on {t.device}, expected {device}")
        require(t.is_contiguous(), f"{name}: {arg} must be contiguous")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
