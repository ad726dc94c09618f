"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/plastic_unet_tpu_torch/`` beside the package, on first use. All
sources are compiled at once, one ``nvcc`` process each, started together.
The library name carries a hash of its source and of the headers
(``csrc/*.cuh``) the sources share, so an edited source or header is
rebuilt and a stale library is never loaded. Libraries are loaded with
``ctypes``; every C entry point returns ``cudaGetLastError()`` and
:func:`check` turns a non-zero code into an exception.

Nothing here runs at import time: the CPU tests import every module of the
package on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "plastic_unet_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _lib_path(src: Path) -> Path:
    """The library's path, named by a hash of its source, the shared headers of csrc/ and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}.{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: library path}. Each library's ptxas report (registers,
    shared memory, spills) is kept beside it as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    paths = {s.stem: _lib_path(s) for s in srcs}
    todo = [s for s in srcs if not paths[s.stem].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = paths[s.stem].with_suffix(f".{os.getpid()}.tmp")
        log = open(paths[s.stem].with_suffix(".so.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for s, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[s.stem])
        else:
            failed.append(f"{s.name} (rc={rc}):\n{paths[s.stem].with_suffix('.so.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C function to its argtypes; all return int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None passes NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
