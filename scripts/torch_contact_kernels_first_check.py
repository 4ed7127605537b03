#!/usr/bin/env python3
"""First check of the contact kernels on a card: build, compare, time.

    python3 scripts/torch_contact_kernels_first_check.py

Builds the port's CUDA kernels (printing ptxas's registers and spills),
then on the cartpole with the narrowed limits (-0.6, -0.5) / (0.6, 0.5),
B=512, T=100, x0 with the cart and pole within +-0.5 and both velocities
within +-2, and u from numpy (std 8, seed 0), holds K6 ``rollout_classes``,
K4 ``linearize_split`` (PCG depth m + 6 and 4) and K2 ``rollout_gains`` with
classes against their plain versions in f64 and f32, and times each kernel
(mean of 5 calls by CUDA events). The short first call a new kernel gets
before the full ``chip_smoke.py``; needs one CUDA card.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nimblephysics_tpu_torch.models import builders  # noqa: E402
from nimblephysics_tpu_torch.ops import _build  # noqa: E402
from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_split, linearize_split_plain  # noqa: E402
from nimblephysics_tpu_torch.ops.cuda_rollout import (  # noqa: E402
    rollout_classes,
    rollout_classes_plain,
    rollout_gains,
    rollout_gains_plain,
)
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost  # noqa: E402

B, T = 512, 100
ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    _, seconds = _build.build()
    _build.load()
    print(f"build {seconds:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    dev = torch.device("cuda")
    for dtype in (torch.float64, torch.float32):
        m = builders.cartpole(dt=0.02, dtype=dtype, device=dev).replace(
            q_lower=torch.tensor([-0.6, -0.5], dtype=dtype, device=dev),
            q_upper=torch.tensor([0.6, 0.5], dtype=dtype, device=dev))
        rng = np.random.default_rng(0)
        x0 = torch.tensor(np.concatenate([rng.uniform(-0.5, 0.5, (B, 2)),
                                          rng.uniform(-2, 2, (B, 2))], 1), dtype=dtype, device=dev)
        u = torch.tensor(8 * rng.standard_normal((B, T, 1)), dtype=dtype, device=dev)
        xk, ck = rollout_classes(m, x0, u)
        torch.cuda.synchronize()
        xp, cp = rollout_classes_plain(m, x0, u)
        print(f"{dtype} K6 xs err {float((xk - xp).abs().max()):.3e}, classes differ at "
              f"{int((ck.cmask != cp.cmask).sum())}, active share "
              f"{float(cp.cmask.amax(-1).mean()):.4f}", flush=True)
        xs = torch.cat([x0[:, None], xp[:, :-1]], 1).contiguous()
        cl = (cp.cmask.contiguous(), cp.us.contiguous())
        for cg in (None, 4):
            fk = linearize_split(m, xs, u, cl, cg)
            torch.cuda.synchronize()
            fp = linearize_split_plain(m, xs, u, cl, cg)
            print(f"{dtype} cg_iters={cg} K4 rel err {[rel(a, b) for a, b in zip(fk, fp)]}",
                  flush=True)
        rc, fc = QuadraticCost(m, wq=0.1, wu=1e-3), QuadraticFinalCost(m, wx=10.0)
        K = 0.3 * torch.tensor(rng.standard_normal((B, T, 1, 4)), dtype=dtype, device=dev)
        k = torch.tensor(rng.standard_normal((B, T, 1)), dtype=dtype, device=dev)
        xr = torch.cat([x0[:, None], xp], 1).contiguous()
        al = torch.tensor(ALPHAS, dtype=dtype, device=dev)
        rk = rollout_gains(m, rc, fc, x0, xr, u, K, k, al, classes=cl)
        torch.cuda.synchronize()
        rp = rollout_gains_plain(m, rc, fc, x0, xr, u, K, k, al, classes=cl)
        print(f"{dtype} K2 with classes rel err {[rel(a, b) for a, b in zip(rk, rp)]}", flush=True)
        for name, fn in (("K6", lambda: rollout_classes(m, x0, u)),
                         ("K4", lambda: linearize_split(m, xs, u, cl)),
                         ("K2 with classes",
                          lambda: rollout_gains(m, rc, fc, x0, xr, u, K, k, al, classes=cl))):
            print(f"{name} {dtype} {time_ms(fn):.4f} ms")
    print(f"total {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
