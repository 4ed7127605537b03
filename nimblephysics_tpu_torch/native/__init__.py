"""Native C++ runtime of the serving edge, loaded with ctypes.

PyTorch counterpart of ``nimblephysics_tpu/native``, over this package's
own copies of its two sources:

  * ``RtControlBuffer``: seqlock double-buffered control plans
    (``realtime_buffer.cpp``): the planner thread publishes, control
    threads read without a lock and without the GIL;
  * ``ticker_now`` / ``ticker_sleep_until``: the monotonic clock and
    precise periodic timing;
  * ``lcp_gold``: a deeply converged boxed-LCP solver (``lcp_gold.cpp``),
    the independent reference the tests hold the port's PGS to.

The library is built at first use with ``g++ -O2 -fPIC -std=c++17 -shared
-pthread`` into ``_build/native-<hash of the sources and flags>/`` (beside
the CUDA kernels' library, ``ops/_build.py``), renamed into place when
complete; nothing is built at import time, and a failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from nimblephysics_tpu_torch.ops._build import BUILD_ROOT

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("realtime_buffer.cpp", "lcp_gold.cpp")
LIB_NAME = "libnptt_native.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-pthread")
BUILD_TIMEOUT_S = 300

_LOCK = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Build the library if it is missing; returns its path. Raises
    RuntimeError, with the compiler's output, if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native serving library is built at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed ({' '.join(cmd)}):\n"
                           + (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
        lib.rtb_create.restype = ctypes.c_void_p
        lib.rtb_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rtb_destroy.argtypes = [ctypes.c_void_p]
        lib.rtb_publish.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double, dp]
        lib.rtb_control_at.restype = ctypes.c_int
        lib.rtb_control_at.argtypes = [ctypes.c_void_p, ctypes.c_double, dp]
        lib.rtb_num_published.restype = ctypes.c_uint64
        lib.rtb_num_published.argtypes = [ctypes.c_void_p]
        lib.ticker_now.restype = ctypes.c_double
        lib.ticker_sleep_until.argtypes = [ctypes.c_double]
        lib.lcp_gold_solve.restype = ctypes.c_double
        lib.lcp_gold_solve.argtypes = [dp, dp, dp, dp, dp, ip, ctypes.c_int, ctypes.c_int, dp]
        _lib = lib
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


class RtControlBuffer:
    """Native double-buffered control plan (RealTimeControlBuffer)."""

    def __init__(self, horizon: int, na: int):
        self._lib = _load()
        self.horizon, self.na = horizon, na
        self._h = self._lib.rtb_create(horizon, na)

    def publish(self, start_time: float, dt: float, u) -> None:
        """Publish u (horizon, na), a numpy array or a tensor on any device."""
        if hasattr(u, "detach"):
            u = u.detach().cpu().numpy()
        u = _f64(u)
        if u.shape != (self.horizon, self.na):
            raise ValueError(f"u has shape {u.shape}, expected {(self.horizon, self.na)}")
        self._lib.rtb_publish(self._h, float(start_time), float(dt), _dptr(u))

    def control_at(self, t: float):
        """(row index, u (na,)) of the plan at wall time t, or (None, None)
        before the first publish."""
        out = np.zeros(self.na, dtype=np.float64)
        idx = self._lib.rtb_control_at(self._h, float(t), _dptr(out))
        return (idx, out) if idx >= 0 else (None, None)

    @property
    def num_published(self) -> int:
        return int(self._lib.rtb_num_published(self._h))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.rtb_destroy(h)


def ticker_now() -> float:
    return float(_load().ticker_now())


def ticker_sleep_until(t: float) -> None:
    _load().ticker_sleep_until(float(t))


def lcp_gold(A, b, lo, hi, fscale, findex, iters: int = 10000):
    """Deep-convergence boxed LCP; returns (x, complementarity residual)."""
    lib = _load()
    A, b, lo, hi, fscale = (_f64(a) for a in (A, b, lo, hi, fscale))
    fi = np.ascontiguousarray(np.asarray(findex, dtype=np.int32))
    m = b.shape[0]
    x = np.zeros(m, dtype=np.float64)
    resid = lib.lcp_gold_solve(_dptr(A), _dptr(b), _dptr(lo), _dptr(hi), _dptr(fscale),
                               fi.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), m, int(iters),
                               _dptr(x))
    return x, float(resid)
