#!/usr/bin/env python3
"""First check of K7's shared-memory body (csrc/lcp_wide.cu) on a card.

    python3 scripts/torch_k7_wide_check.py      # on one CUDA card, ~20 s

Builds csrc/lcp.cu and csrc/lcp_wide.cu alone into a library of their own
(printing ptxas's registers and spills), prints the layout of K7's
instances at m = 129, 28 and 3 (3 has none), then on the 62 catapult_swing
LCPs of tests/golden/world_lcp_golden.npz (m = 129) holds the wide body to
pgs_batched_plain at 60 sweeps in f64 and f32, holds its velocities v* +
Minv_Jt x at 10,000 sweeps in f64 to the reference's Dantzig answers, and
times it in f64 and f32 at B = 2,048 (the 62 repeated, mean of 10 calls by
CUDA events). chip_smoke.py phase 16a runs the same checks through the
wrapper after the full build.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nimblephysics_tpu_torch.ops import _build  # noqa: E402
from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched_plain  # noqa: E402

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden" / "world_lcp_golden.npz"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k7_wide_check: CUDA is not available", file=sys.stderr)
        return 1
    lib_path = Path(tempfile.mkdtemp(prefix="k7wide_")) / "libk7wide.so"
    secs, log = _build.compile_library([_build.CSRC_DIR / "lcp.cu",
                                        _build.CSRC_DIR / "lcp_wide.cu"], lib_path)
    print(f"build {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ", line.strip())
    lib = ctypes.CDLL(str(lib_path))
    for name in ("nptt_pgs", "nptt_pgs_wide", "nptt_pgs_group_shape"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    for dbl in (0, 1):
        for m in (129, 28, 3):
            out = (ctypes.c_longlong * 3)()
            rc = lib.nptt_pgs_group_shape(dbl, m, out)
            print(f"layout {'f64' if dbl else 'f32'} m = {m}: rc {rc}, "
                  f"{list(out) if rc == 0 else 'no instance'}")
    dev = torch.device("cuda")
    d = np.load(GOLDEN)
    ps = [p for p in range(int(d["n_problems"])) if "catapult_swing" in str(d[f"w{p}_name"])]
    findex = tuple(int(v) for v in d[f"w{ps[0]}_findex"])
    fi = torch.tensor(findex, dtype=torch.int32, device=dev)

    def wide(A, b, lo, hi, fs, x0, iters):
        x = torch.empty_like(b)
        rc = lib.nptt_pgs_wide(int(b.dtype == torch.float64), b.shape[1], b.shape[0], iters,
                               *(t.data_ptr() for t in (A, b, lo, hi, fs, x0, fi, x)),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nptt_pgs_wide: rc {rc}")
        return x

    for dtype in (torch.float64, torch.float32):
        def get(k):
            return torch.tensor(np.stack([d[f"w{p}_{k}"] for p in ps]), dtype=dtype, device=dev)

        A, b, lo, hi, fs = (get(k) for k in ("A", "b", "lo", "hi", "fscale"))
        x0 = torch.zeros_like(b)
        xk = wide(A, b, lo, hi, fs, x0, 60)
        t0 = time.perf_counter()
        xp = pgs_batched_plain(A, b, lo, hi, fs, x0, findex, 60)
        torch.cuda.synchronize()
        err = float((xk - xp).abs().max())
        print(f"{dtype}, 60 sweeps: max abs err {err:.3e}, rel {err / float(xp.abs().max()):.3e} "
              f"(plain {time.perf_counter() - t0:.2f} s)")
        if dtype == torch.float64:
            xk = wide(A, b, lo, hi, fs, x0, 10_000)
            Mj, vs, xr = (get(k) for k in ("Minv_Jt", "v_star", "x_ref"))
            v, vr = (vs + (Mj @ x[..., None])[..., 0] for x in (xk, xr))
            e = float(((v - vr).abs().amax(-1) / vr.abs().amax(-1).clamp(min=1.0)).max())
            print(f"10,000 sweeps: velocities within {e:.3e} of the reference's")
        rep = -(-2048 // len(ps))
        big = [t.repeat((rep,) + (1,) * (t.dim() - 1))[:2048].contiguous()
               for t in (A, b, lo, hi, fs)]
        x0b = torch.zeros_like(big[1])
        for _ in range(2):
            wide(*big, x0b, 60)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            wide(*big, x0b, 60)
        ev[1].record()
        torch.cuda.synchronize()
        print(f"{dtype}, B = 2,048, 60 sweeps: {ev[0].elapsed_time(ev[1]) / 10:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
