"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` and links them into one
shared library with a plain C interface (no PyTorch headers), which is
loaded with ctypes.
The library goes to ``_build/<hash of the sources and flags>/``: a changed
source gets a new directory, so a stale library is never loaded, and the
file is renamed into place when complete, so no lock file is needed.
Nothing is built at import time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libnptt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 900

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of each extern "C" launcher; every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
SIGNATURES = {
    "nptt_riccati": [_I, _I, _I, _LL, _I] + [_P] * 8,
    "nptt_linearize": [_I, _I, _I, _I, _LL] + [_P] * 7,
    "nptt_rollout": [_I, _I, _I, _I, _I, _I, _LL, _LL, _I, _I] + [_P] * 15,
    "nptt_linearize_split": [_I, _I, _I, _I, _I, _LL, _I] + [_P] * 9,
    "nptt_rollout_classes": [_I, _I, _I, _I, _I, _LL, _I] + [_P] * 6,
    "nptt_linearize_vjp": [_I, _I, _I, _I, _I, _I, _LL, _I] + [_P] * 9,
    "nptt_pgs": [_I, _I, _LL, _I] + [_P] * 9,
    "nptt_rollout_group_shape": [_I, _P],
    "nptt_linearize_vjp_group_shape": [_I, _P],
    "nptt_linearize_split_group_shape": [_I, _P],
    "nptt_pgs_group_shape": [_I, _P],
}


def sources() -> list:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on first use and need the toolkit")


def build() -> tuple:
    """Build the library if it is missing, with one ``nvcc`` call. Returns
    (path, seconds spent building, 0.0 when the library was already
    there)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *[str(p) for p in sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s") from e
    seconds = time.perf_counter() - t0
    (lib.parent / "nvcc.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + proc.stderr[-4000:])
    os.replace(tmp, lib)
    return lib, seconds


def build_log() -> str:
    """nvcc's output for the current sources (ptxas registers and spills)."""
    log = library_path().parent / "nvcc.log"
    return log.read_text() if log.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc == -1:
        raise ValueError(f"{name}: no kernel instance for these sizes (the "
                         "instances are listed in the launcher in csrc/)")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_inputs(name: str, tensors: dict, contiguous=()) -> tuple:
    """Validate a kernel's inputs; returns their common (device, dtype).

    All tensors must share one device and one dtype (float32 or float64),
    and none may require grad: the kernels are forward-only. Those named in
    ``contiguous`` are handed to the kernel as raw pointers and must be
    contiguous."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is not float32 or float64")
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} is not a tensor")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
        if t.requires_grad:
            raise RuntimeError(f"{name}: {key} requires grad, but the kernel "
                               "is forward-only")
        if key in contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev, dtype


def check_shape(name: str, key: str, t, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def group_shape(name: str, dtype) -> dict:
    """The lane-group layout of K2's worm instance (``name`` "rollout"),
    K4's ("linearize_split"), K5's ("linearize_vjp") or K7's ("pgs"): lanes
    per group, groups per block and shared bytes per block
    (csrc/frozen_group.cuh, csrc/lcp.cu)."""
    out = (ctypes.c_longlong * 3)()
    getattr(load(), f"nptt_{name}_group_shape")(int(dtype == torch.float64), out)
    return {"lanes": out[0], "groups_per_block": out[1], "shared_bytes": out[2]}


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
