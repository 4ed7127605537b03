#!/usr/bin/env python3
"""How far the JAX package's f64 frozen-class linearize kernel is from the
function it linearizes, and what that does to its contact replan; CPU only.

    JAX_PLATFORMS=cpu python3 scripts/torch_split_f64_check.py

On the cartpole with the narrowed limits (-0.6, -0.5) / (0.6, 0.5), B=4,
T=10, x0 and u built as tests/test_torch_contact_kernels.py builds them
(numpy seed 3), it prints:

  * ``linearize_pallas_split`` (interpret mode, block_b=128) in f64 against
    ``jax.jacfwd`` of the package's own ``dyn_frozen_for_trace``, and the
    port's ``linearize_split_plain`` against the same jacfwd;
  * the JAX ``solve_contact_mpc_batch`` (2 iterations, one outer iteration,
    seeded with the K6 Pallas classes of u0 = 0) with ``linearize="auto"``
    (which takes that kernel) against ``linearize="xla"``, and the port's
    plain ``solve_contact_mpc_batch`` against the latter.
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
import torch  # noqa: E402

from nimblephysics_tpu.models import builders as jb  # noqa: E402
from nimblephysics_tpu.ops.pallas_linearize import (  # noqa: E402
    dyn_frozen_for_trace,
    linearize_pallas_split,
)
from nimblephysics_tpu.ops.pallas_rollout import rollout_classes_pallas  # noqa: E402
from nimblephysics_tpu.trajectory.ilqr import ILQRConfig as JConfig  # noqa: E402
from nimblephysics_tpu.trajectory.ilqr import solve_contact_mpc_batch as j_mpc  # noqa: E402

from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_split_plain  # noqa: E402
from nimblephysics_tpu_torch.ops.frozen_contact import FrozenClasses  # noqa: E402
from nimblephysics_tpu_torch.trajectory.ilqr import ILQRConfig, solve_contact_mpc_batch  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    jax_cartpole_costs,
    port_cartpole_costs,
    t64,
    to_port,
)

B, T = 4, 10


def main() -> None:
    mj = jb.cartpole(dt=0.02).replace(q_lower=jnp.asarray([-0.6, -0.5]),
                                      q_upper=jnp.asarray([0.6, 0.5]))
    mt = to_port(mj)
    rng = np.random.default_rng(3)
    x0 = np.concatenate([rng.uniform(-0.55, 0.55, (B, 1)), rng.uniform(-0.45, 0.45, (B, 1)),
                         rng.uniform(-2.0, 2.0, (B, 2))], axis=1)
    u = np.concatenate([np.full((B, T // 2, 1), 20.0), rng.uniform(-20, 20, (B, T - T // 2, 1))],
                       axis=1)
    xs, cl = rollout_classes_pallas(mj, jnp.asarray(x0), jnp.asarray(u), block_b=128,
                                    interpret=True)
    pre = np.concatenate([x0[:, None], np.asarray(xs)[:, :-1]], axis=1)
    classes = (cl.cmask, cl.us)
    fx_s, fu_s = linearize_pallas_split(mj, jnp.asarray(pre), jnp.asarray(u), classes,
                                        block_b=128, interpret=True)
    pts = lambda a: jnp.asarray(np.asarray(a).reshape(B * T, -1))  # noqa: E731
    fx_j, fu_j = jax.jit(jax.vmap(jax.jacfwd(dyn_frozen_for_trace(mj), argnums=(0, 1))))(
        pts(pre), pts(u), pts(cl.cmask), pts(cl.us))
    fx_j = np.asarray(fx_j).reshape(B, T, 4, 4)
    fu_j = np.asarray(fu_j).reshape(B, T, 4, 1)
    fx_t, fu_t = linearize_split_plain(mt, t64(pre), t64(u), (t64(cl.cmask), t64(cl.us)))
    rel = lambda a, b: float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())  # noqa: E731
    print(f"linearize_pallas_split f64 vs jacfwd: fx rel {rel(fx_s, fx_j):.3e}, "
          f"fu abs {float(np.abs(np.asarray(fu_s) - fu_j).max()):.3e}")
    print(f"port linearize_split_plain vs jacfwd: fx rel {rel(fx_t.numpy(), fx_j):.3e}, "
          f"fu abs {float(np.abs(fu_t.numpy() - fu_j).max()):.3e}")

    run_j, fin_j = jax_cartpole_costs(2)
    u0 = jnp.zeros((B, T, 1))
    _, cl0 = rollout_classes_pallas(mj, jnp.asarray(x0), u0, block_b=128, interpret=True)
    sols = {}
    for lin in ("auto", "xla"):
        solve = jax.jit(lambda x, u_, cm, us, lin=lin: j_mpc(
            mj, x, u_, run_j, fin_j, JConfig(iters=2, linearize=lin, unroll=1),
            outer_iters=1, block_b=128, classes=type(cl0)(cmask=cm, us=us)))
        sols[lin] = solve(jnp.asarray(x0), u0, cl0.cmask, cl0.us)[0]
    run_t, fin_t = port_cartpole_costs(mt)
    sol_t, _ = solve_contact_mpc_batch(mt, t64(x0), torch.zeros(B, T, 1, dtype=torch.float64),
                                       run_t, fin_t, ILQRConfig(iters=2), outer_iters=1,
                                       classes=FrozenClasses(t64(cl0.cmask), t64(cl0.us)))
    du = float(np.abs(np.asarray(sols["auto"].u) - np.asarray(sols["xla"].u)).max())
    dc = float(np.abs(np.asarray(sols["auto"].cost) - np.asarray(sols["xla"].cost)).max())
    print(f"JAX solve_contact_mpc_batch, linearize auto vs xla: |du| {du:.3e}, |dcost| {dc:.3e}")
    du = float(np.abs(sol_t.u.numpy() - np.asarray(sols["xla"].u)).max())
    dc = float(np.abs(sol_t.cost.numpy() - np.asarray(sols["xla"].cost)).max())
    print(f"port solve_contact_mpc_batch vs JAX linearize xla: |du| {du:.3e}, |dcost| {dc:.3e}")


if __name__ == "__main__":
    main()
