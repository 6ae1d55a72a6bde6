"""Builds the port's CUDA kernels from ``ops/csrc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/ics_tpu_torch/lib<name>-<digest>.so`` under the repository root
(listed in ``.gitignore``). The digest covers the sources and the flags, so
an edited kernel is rebuilt and an unchanged one is loaded as it is, by any
process of the same checkout. Nothing here runs at import time: the first
wrapper call on a CUDA tensor builds what it needs, and ``build`` starts one
``nvcc`` per kernel, all at once, for callers that want every kernel ready
up front. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ics_tpu_torch"
KERNELS = ("flash_attention", "bottleneck_chain", "normalize_u8", "depthwise_conv",
           "window_attention", "window_attention_bwd", "depthwise_conv_dw")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {path.parent}); "
            "the CUDA kernels can only be built where the CUDA toolkit is installed"
        )
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    each, all started together. Returns ``{name: compiler output}`` (the
    ``-Xptxas -v`` register and shared-memory report); an empty string marks
    a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    procs = {}
    logs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                logs[name] = ""
                continue
            compiler = compiler or nvcc()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs[name] = (proc, tmp, out)
        for name, (proc, tmp, out) in procs.items():
            output, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{output}"
                )
            os.replace(tmp, out)  # atomic: a concurrent build of the same digest is harmless
            logs[name] = output
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
