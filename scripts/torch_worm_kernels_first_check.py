#!/usr/bin/env python3
"""First check of the worm path's kernels on a card: build, compare, time.

    python3 scripts/torch_worm_kernels_first_check.py           # on one CUDA card
    python3 scripts/torch_worm_kernels_first_check.py --cpu     # rehearsal, tiny

Builds the port's CUDA kernels (printing ptxas's registers and spills for
the new instances), then on the jump worm (chip_smoke.py's worm inputs:
bench.py's x0, u from numpy, the plain pointwise refresh's states and
classes) holds K7 ``pgs_batched``, K5 ``linearize_vjp``, K2 ``rollout_gains``
with classes at m = 28 and K1 at (nx, na) = (8, 2) against their plain
versions in f64 and f32 at B=64, T=100, then K2 over one step and K5 on
chip_smoke.py's 256 sliding points at PCG depths 1 and 2 with no row
excused, prints the lane-group layout of K2's worm instance and K5, then
runs them at B=512, T=100 in f32 (chip_smoke.py's compare_worm), and times
each kernel there (mean of 5 calls by CUDA events). The short first call the new
kernels get before the full ``chip_smoke.py``. With ``--cpu`` it runs the
same calls on the plain versions at B=2, T=5 (no timing).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nimblephysics_tpu_torch.ops import _build  # noqa: E402

KERNELS = {"pgs_batched": cs.pgs_batched, "linearize_vjp": cs.linearize_vjp,
           "rollout_gains[worm]": cs.rollout_gains,
           "riccati_backward[worm]": cs.riccati_backward}
PLAIN = {"pgs_batched": cs.pgs_batched_plain, "linearize_vjp": cs.linearize_vjp_plain,
         "rollout_gains[worm]": cs.rollout_gains_plain,
         "riccati_backward[worm]": cs.riccati_backward_plain}


def main() -> int:
    cpu = "--cpu" in sys.argv
    if not cpu and not torch.cuda.is_available():
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if cpu else "cuda")
    t0 = time.perf_counter()
    if not cpu:
        path, s = _build.build()
        _build.load()
        print(f"build {s:.1f} s -> {path}", flush=True)
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip())
    B, T = (2, 5) if cpu else (64, 100)
    worst = {}
    for dtype in (torch.float64, torch.float32):
        inputs = cs.worm_kernel_inputs(dev, B, T, dtype)
        for name, (args, kw) in inputs.items():
            out_k = KERNELS[name](*args, **kw)
            out_p = PLAIN[name](*args, **kw)
            if isinstance(out_k, torch.Tensor):
                out_k, out_p = (out_k,), (out_p,)
            pairs = [(a, b) for a, b in zip(out_k, out_p) if a.dtype != torch.bool]
            abs_err, rel_err = cs.rel_errors(*zip(*pairs))
            # per-point relative error, to see whether a few points carry it
            a, b = pairs[0]
            per = ((a - b).abs().reshape(a.shape[0], -1).amax(-1)
                   / b.abs().reshape(b.shape[0], -1).amax(-1).clamp(min=1e-30))
            worst[(name, str(dtype))] = rel_err
            print(f"{name:24s} {str(dtype):14s} abs {abs_err:.3e} rel {rel_err:.3e}; "
                  f"per-row rel: median {float(per.median()):.3e}, max {float(per.max()):.3e}, "
                  f"rows above 1e-9 {int((per > 1e-9).sum())} of {per.numel()}", flush=True)
        cl = inputs["linearize_vjp"][0][3]
        print(f"  classes: {float((cl[0].amax(-1) > 0).float().mean()):.4f} of the points clamp, "
              f"{int((cl[1] != 0).sum())} UPPER rows", flush=True)
    if not cpu:
        cs.check_coupled_rows(dev)
        for dt in (torch.float32, torch.float64):
            print(f"rollout lane groups: {dt} {_build.layout('rollout', cs.WORM_M, dt)}; "
                  f"linearize_vjp lane groups: {dt} {_build.group_shape('linearize_vjp', dt)}",
                  flush=True)
        full = cs.worm_kernel_inputs(dev, 512, 100, torch.float32)
        for name, (args, kw) in full.items():
            abs_err, rel_err = cs.compare_worm(name, args, kw, "float32")
            ms = cs.time_ms(lambda: KERNELS[name](*args, **kw), 5)
            print(f"{name:24s} f32 B=512 T=100: {ms:.4f} ms (rel err {rel_err:.3e})", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
