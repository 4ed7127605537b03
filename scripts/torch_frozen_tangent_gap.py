#!/usr/bin/env python3
"""How far the derivative of the truncated PCG iteration lies from the
implicit tangent that K4 (``linearize_split``) takes; CPU only, torch only.

    python3 scripts/torch_frozen_tangent_gap.py

The frozen solve runs a fixed number of Jacobi-PCG iterations (m + 6 by
default, ``cg_iters`` when given). The JAX package differentiates it as a
linear solve (``lax.custom_linear_solve``): one more PCG on the tangent's
right-hand side. Dual numbers pushed through the iterations would give the
derivative of the truncated iteration instead. On the inputs of
``chip_smoke.py``'s phase 5 (narrowed-limit cartpole, B=512 worlds from
its x0, u with std 5 from seed 0, T=100, the classes of the plain full-LCP
rollout), in f64, this prints for PCG depths 10, 4, 2 and 1 the largest
difference between the two Jacobians (fx, fu) relative to their largest
entry, beside the tolerance of the kernel checks (f64 1e-9, f32 2e-4),
and how many points have two rows clamping (the cartpole has at most one
clamping row per dof, so the PCG converges in two iterations and only one
iteration stops short). The gap is a property of the iteration, so f64
shows it without f32's rounding on top.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nimblephysics_tpu_torch.ops import frozen_contact  # noqa: E402
from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_split_plain  # noqa: E402
from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_classes_plain  # noqa: E402

B, T = 512, 100
DEPTHS = (10, 4, 2, 1)


class _Iterated:
    """solve_frozen's PCG with forward mode through its iterations."""

    @staticmethod
    def apply(Qf, reg, diagM, bvec, n_cg):
        return frozen_contact._pcg(Qf, reg, diagM, bvec, n_cg)


def jacobians(args, cg, iterated):
    implicit = frozen_contact._FrozenPCG
    if iterated:
        frozen_contact._FrozenPCG = _Iterated
    try:
        return linearize_split_plain(*args, cg_iters=cg)
    finally:
        frozen_contact._FrozenPCG = implicit


def main() -> int:
    dev, dtype = torch.device("cpu"), torch.float64
    model = cs.contact_model(dev, dtype, True)
    x0 = torch.tensor(cs.contact_x0(B, True), dtype=dtype)
    u = torch.tensor(5.0 * np.random.default_rng(cs.SEED).standard_normal((B, T, 1)),
                     dtype=dtype)
    xs_post, cl = rollout_classes_plain(model, x0, u)
    pre = torch.cat([x0[:, None], xs_post[:, :-1]], dim=1).contiguous()
    args = (model, pre, u, (cl.cmask.contiguous(), cl.us.contiguous()))
    rows = cl.cmask.sum(-1)
    print(f"float64: points with 0/1/2 clamping rows: "
          f"{[int((rows == k).sum()) for k in range(3)]} of {B * T}")
    for cg in DEPTHS:
        imp = jacobians(args, cg, False)
        itr = jacobians(args, cg, True)
        gap = max(float((a - b).abs().max()) / float(a.abs().max()) for a, b in zip(imp, itr))
        print(f"  cg_iters={cg:2d}: max |J_iterated - J_implicit| / max |J_implicit| = "
              f"{gap:.3e} (kernel check tolerance f64 {cs.TOL['float64']:.0e}, "
              f"f32 {cs.TOL['float32']:.0e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
