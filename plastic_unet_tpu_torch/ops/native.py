"""ctypes bindings of the native host library (counterpart of
plastic_unet_tpu.ops.native): the threaded RLE encoder, PNG loader and IoU
threshold sweep of ``native/plasticnet_native.cc``, a source the port shares
with the JAX package and never writes beside.

The library is built on first use with the flags of ``native/Makefile``
(``g++ -O3 -march=native -fPIC -std=c++17 -shared ... -lpng -lpthread``) into
``build/plastic_unet_tpu_torch/`` (``ops._build.BUILD_DIR``), under a name
that carries a hash of the source, the compiler, the flags and the host's
CPU: an edited source is rebuilt, and a library built for another CPU
(``-march=native``) is never loaded. The compiler writes a temporary file
that is then renamed, so processes that build at once leave one whole
library.

Fallback rule: the callers (``ops.rle.encode_batch``,
``data.dataset._load_batch``) take the numpy/PIL path only where the library
cannot be built or loaded (:func:`load` returns None); the reason is printed
once and kept in :func:`native_status`. An error raised by a loaded library
propagates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from plastic_unet_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "plasticnet_native.cc"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LDLIBS = ["-lpng", "-lpthread"]
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None
_error: str | None = None  # why the library cannot be built or loaded
_status = "not tried"
_warned = False


def _threads() -> int:
    return max(os.cpu_count() or 1, 1)


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _host_cpu() -> str:
    """The CPU that ``-march=native`` compiles for: the machine and its model name."""
    model = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), model)
    except OSError:
        pass
    return f"{platform.machine()} {model}"


def lib_path() -> Path:
    """The library's path, named by a hash of the source, compiler, flags and host CPU."""
    if not SOURCE.exists():
        raise OSError(f"native source {SOURCE} not found")
    key = SOURCE.read_bytes() + " ".join([_cxx(), *CXX_FLAGS, *LDLIBS, _host_cpu()]).encode()
    return BUILD_DIR / f"libplasticnet_native.{hashlib.sha256(key).hexdigest()[:12]}.so"


def _compile(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise OSError(f"{cmd[0]} could not run: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"{cmd[0]} failed (rc={out.returncode}): {out.stderr.strip()[-2000:]}")
    os.replace(tmp, path)


def get_lib():
    """The loaded library, built on first use; raises OSError when it cannot be built or loaded."""
    global _lib, _error, _status
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise OSError(_error)
        try:
            path = lib_path()
            t0 = time.perf_counter()
            built = not path.exists()
            if built:
                _compile(path)
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _error = str(e)
            _status = f"unavailable: {_error}"
            raise
        lib.rle_encode_batch.restype = ctypes.c_longlong
        lib.rle_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
        ]
        lib.load_png_gray_batch.restype = ctypes.c_int
        lib.load_png_gray_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.iou_threshold_sweep.restype = None
        lib.iou_threshold_sweep.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        how = f"built in {time.perf_counter() - t0:.1f} s" if built else "built before"
        _status = f"loaded {path} ({how})"
        _lib = lib
        return _lib


def load():
    """The library, or None where it cannot be built or loaded (the reason
    printed once to stderr and kept in :func:`native_status`)."""
    global _warned
    try:
        return get_lib()
    except OSError:
        if not _warned:
            _warned = True
            print(f"native host library unavailable, numpy/PIL fallback: {_error}", file=sys.stderr)
        return None


def native_status() -> str:
    """Whether the library loaded (its path, and whether this process built
    it) or, if not, the compiler's or the loader's reason."""
    load()
    return _status


def rle_encode_batch_native(masks: np.ndarray, chunk: int = 512) -> list[str]:
    """Batch column-major RLE via C++. masks: (N, H, W) binarizable array."""
    lib = get_lib()
    masks = np.ascontiguousarray((np.asarray(masks) != 0).astype(np.uint8))
    if masks.ndim != 3:
        raise ValueError(f"masks must be (N, H, W), got shape {masks.shape}")
    n, h, w = masks.shape
    out: list[str] = []
    # worst case per mask: alternating pixels -> h*w/2 pairs * ~14 chars
    cap_per = 8 * h * w + 16
    for i in range(0, n, chunk):
        batch = masks[i : i + chunk]
        buf = ctypes.create_string_buffer(cap_per * len(batch))
        written = lib.rle_encode_batch(
            batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(batch), h, w, buf, len(buf), _threads(),
        )
        if written < 0:
            raise OverflowError("RLE output buffer overflow")
        raw = buf.raw[:written]
        out.extend(s.decode() for s in raw.split(b"\0")[:-1])
    return out


def load_png_gray_batch_native(paths: list[str], h: int, w: int) -> np.ndarray:
    """Threaded PNG grayscale batch load via C++. Returns (N, h, w) float64
    with data.images.load_image's semantics."""
    lib = get_lib()
    out = np.empty((len(paths), h, w), dtype=np.float64)
    joined = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    failures = lib.load_png_gray_batch(
        joined, len(paths), h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _threads()
    )
    if failures:
        raise IOError(f"{failures} PNG file(s) failed to load")
    return out


def iou_threshold_sweep_native(y_true: np.ndarray, preds: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """(T,) float32 Kaggle batch IoU of ``preds > thr`` for each threshold,
    on the host (ops.iou.iou_metric_batch per threshold)."""
    lib = get_lib()
    n = y_true.shape[0]
    t = np.ascontiguousarray(np.asarray(y_true, np.float32).reshape(n, -1))
    p = np.ascontiguousarray(np.asarray(preds, np.float32).reshape(n, -1))
    if p.shape != t.shape:
        raise ValueError(f"y_true {t.shape} and preds {p.shape} differ in size")
    thr = np.ascontiguousarray(np.asarray(thresholds, np.float32).reshape(-1))
    out = np.empty(len(thr), dtype=np.float32)
    lib.iou_threshold_sweep(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, t.shape[1],
        thr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(thr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _threads(),
    )
    return out
