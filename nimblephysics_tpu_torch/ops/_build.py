"""Build and load the port's CUDA kernels.

One ``nvcc -c`` per ``csrc/*.cu``, all started together, then one link
make one shared library with a plain C interface (no PyTorch headers),
which is loaded with ctypes.
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
    "nptt_riccati": [_I, _I, _I, _LL, _I] + [_P] * 15,
    "nptt_riccati_layout": [_I, _I, _I, _P],
    "nptt_linearize": [_I, _I, _I, _I, _LL] + [_P] * 7,
    "nptt_rollout": [_I, _I, _I, _I, _I, _I, _LL, _LL, _I, _I] + [_P] * 15,
    "nptt_linearize_split": [_I, _I, _I, _I, _I, _LL, _I] + [_P] * 9,
    "nptt_classes": [_I] * 7 + [_LL, _I] + [_P] * 7,
    "nptt_linearize_vjp": [_I, _I, _I, _I, _I, _I, _LL, _I] + [_P] * 9,
    "nptt_pgs": [_I, _I, _LL, _I] + [_P] * 9,
    "nptt_linearize_vjp_group_shape": [_I, _P],
    "nptt_pgs_group_shape": [_I, _P],
    "nptt_rollout_layout": [_I, _I, _P],
    "nptt_linearize_split_layout": [_I, _I, _P],
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


def compile_library(cu_files, out: Path) -> tuple:
    """Compile each .cu file with its own ``nvcc -c``, all at once (the
    files share no device code), and link the objects into the shared
    library ``out``. Returns (seconds, nvcc's output: the commands and
    ptxas's registers and spills); raises if a compile or the link fails."""
    work = out.with_name(out.name + ".objs")
    work.mkdir(parents=True, exist_ok=True)
    nvcc, t0, jobs = _nvcc(), time.perf_counter(), []
    for src in cu_files:
        obj, log = work / (Path(src).stem + ".o"), work / (Path(src).stem + ".log")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as f:
            jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for cmd, obj, log, proc in jobs:
        try:
            rc = proc.wait(timeout=max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for *_, p in jobs:
                p.kill()
            raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s") from None
        logs.append(" ".join(cmd) + "\n" + log.read_text())
        if rc != 0:
            failed.append(logs[-1][-4000:])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    cmd = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(out), *[str(o) for _, o, _, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + proc.stderr[-4000:])
    shutil.rmtree(work, ignore_errors=True)
    return time.perf_counter() - t0, "\n".join(logs)


def build() -> tuple:
    """Build the library if it is missing (compile_library). Returns
    (path, seconds spent building, 0.0 when the library was already
    there)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    try:
        seconds, log = compile_library([p for p in sources() if p.suffix == ".cu"], tmp)
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    (lib.parent / "nvcc.log").write_text(log)
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
    """The lane-group layout of K5's worm instance (``name``
    "linearize_vjp") or K7's ("pgs"): lanes per group, groups per block and
    shared bytes per block (csrc/frozen_group.cuh, csrc/lcp.cu)."""
    out = (ctypes.c_longlong * 3)()
    getattr(load(), f"nptt_{name}_group_shape")(int(dtype == torch.float64), out)
    return {"lanes": out[0], "per_block": out[1], "shared_bytes": out[2]}


def layout(name: str, m: int, dtype) -> dict:
    """The layout of K2's instance (``name`` "rollout") or K4's
    ("linearize_split") at m rows: lanes per group (0 for one thread per
    pair or point), groups or threads per block and shared bytes per block
    (csrc/frozen_group.cuh k2_lanes and k4_lanes)."""
    out = (ctypes.c_longlong * 3)()
    check(getattr(load(), f"nptt_{name}_layout")(int(dtype == torch.float64), m, out), name)
    return {"lanes": out[0], "per_block": out[1], "shared_bytes": out[2]}


def riccati_layout(nx: int, na: int, dtype) -> dict:
    """K1's layout at (nx, na) (csrc/riccati.cu riccati_layout): lanes per
    world, worlds per block, steps per staged chunk, shared bytes per
    block."""
    out = (ctypes.c_longlong * 4)()
    check(load().nptt_riccati_layout(int(dtype == torch.float64), nx, na, out), "riccati")
    return {"lanes": out[0], "per_block": out[1], "chunk": out[2], "shared_bytes": out[3]}


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
