"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (shared device
code sits in ``csrc/*.cuh`` headers). All sources
are compiled at once (one ``nvcc`` process each, started together) at the
first launch of any kernel, into ``build/kernels/<hash>/`` at the repository
root, keyed by a hash of the sources and flags. Nothing is built at import
time and no binary is committed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("w4a8_gemv", "w8a8_gemv", "decode_attn", "hh_evict", "flash_prefill", "w4a8_gemm",
           "moe_gemv", "moe_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: What the last build printed (``-Xptxas -v`` register/shared-memory lines)
#: and how long it took; ``chip_smoke.py`` reports both.
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)."
        )
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that is not built yet, all in parallel; return
    the path of each shared library. Raises with the compiler's output if
    any build fails."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [n for n in SOURCES if not paths[n].exists()]
    t0 = time.perf_counter()
    procs = {}
    nvcc = _nvcc()
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    logs = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + "\n"
            + "\n".join(logs[n] for n in failed)
        )
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, built=todo, logs=logs, dir=str(out_dir)
    )
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, building all
    kernels first if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        for n, p in paths.items():
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(p))
        lib = _LIBS[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
