#!/usr/bin/env python3
"""How far the JAX package's f64 row-VJP linearize kernel is from the
function it linearizes; CPU only.

    JAX_PLATFORMS=cpu python3 scripts/torch_vjp_f64_check.py

On the jump worm at tests/test_torch_worm_kernels.py's points (8 states in
floor contact, moving down and sliding, numpy seed 23; their classes from
the port's classify_points), PCG depth 12, it prints
``linearize_pallas_vjp`` (interpret mode, block_b=128) in f64 against
``jax.jacrev`` of the v' half of the package's own ``dyn_frozen_for_trace``,
and the port's ``linearize_vjp_plain`` against the same jacrev.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nimblephysics_tpu.models import builders as jb  # noqa: E402
from nimblephysics_tpu.ops.pallas_linearize import (  # noqa: E402
    dyn_frozen_for_trace,
    linearize_pallas_vjp,
)

from nimblephysics_tpu_torch.ops import frozen_contact as tf  # noqa: E402
from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_vjp_plain  # noqa: E402
from test_torch_worm import worm_states  # noqa: E402
from torch_port_helpers import t64, to_port  # noqa: E402

N, CG = 8, 12


def main() -> None:
    mj = jb.jump_worm(dt=0.001)
    mt = to_port(mj)
    q, v, u = worm_states(N, seed=23)
    x = np.concatenate([q, v], axis=1)
    cl, _ = tf.classify_points(mt, t64(x), mt.action_to_tau(t64(u)))
    cm, us = cl.cmask.numpy(), cl.us.numpy()
    print(f"{int(cm.sum())} clamping rows over {N} points (at most {int(cm.sum(-1).max())} at "
          f"one), {int((us != 0).sum())} UPPER rows")
    dyn = dyn_frozen_for_trace(mj, cg_iters=CG)
    gx, gu = jax.jit(jax.vmap(jax.jacrev(lambda a, b, c, d: dyn(a, b, c, d)[4:],
                                         argnums=(0, 1))))(
        *(jnp.asarray(t) for t in (x, u, cm, us)))
    fx_k, fu_k = linearize_pallas_vjp(mj, *(jnp.asarray(t)[:, None] for t in (x, u)),
                                      tuple(jnp.asarray(t)[:, None] for t in (cm, us)),
                                      block_b=128, interpret=True, cg_iters=CG)
    fx_t, fu_t = linearize_vjp_plain(mt, t64(x)[:, None], t64(u)[:, None],
                                     (t64(cm)[:, None], t64(us)[:, None]), CG)
    gx, gu = np.asarray(gx), np.asarray(gu)

    def rel(a, b):
        return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())

    print(f"linearize_pallas_vjp f64 vs jacrev: fx rel {rel(np.asarray(fx_k)[:, 0, 4:], gx):.3e}, "
          f"fu rel {rel(np.asarray(fu_k)[:, 0, 4:], gu):.3e}")
    print(f"port linearize_vjp_plain vs jacrev: fx rel {rel(fx_t[:, 0, 4:].numpy(), gx):.3e}, "
          f"fu rel {rel(fu_t[:, 0, 4:].numpy(), gu):.3e}")


if __name__ == "__main__":
    main()
