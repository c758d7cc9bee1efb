"""Build and load the CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
on its own into ``build/kernels/<name>-<hash>.so`` at the repository root
(git-ignored), then loaded with ``ctypes``. The hash covers the source, the
shared headers and the flags, so an edited kernel is rebuilt and a built
one is reused. Nothing is built or loaded at import time: the CPU tests
import every module on machines without ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if it is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("ff_attention", "ff_decode_attention", "ff_layer",
                  "ff_matmul", "ff_gather", "ff_attention_proj",
                  "ff_chunk_scan", "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES
          ) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: (seconds, ptxas log)}``
    for the sources compiled by this call; raises on any failure."""
    pending = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, target, time.perf_counter())
    done = {}
    errors = []
    for name, (proc, tmp, target, t0) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)        # atomic: a reader never sees half
        done[name] = (time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """Entry point ``fn`` of library ``name`` with its C signature set
    (pointers and the stream as ``c_void_p``; every entry returns int)."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(name: str, fn: str, rc: int) -> None:
    if rc != 0:
        msg = load(name).repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``: kernels launch on it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def capturing(device) -> bool:
    """Whether PyTorch's current stream on ``device`` is capturing a CUDA
    graph (never on the CPU)."""
    import torch
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())
