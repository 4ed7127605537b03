#!/usr/bin/env python3
"""The serving edge's closed loop on the CPU at two MPCConfigs, the JAX
package's MPC beside the port's (f64):

    python3 scripts/torch_mpc_horizon_check.py

tests/test_realtime.py's loop: the stock cartpole (dt 0.02, its limits
kept) as the plant, q = (0, 0.15), 120 plant steps, a replan every 5, its
costs. For tests/test_realtime.py's MPCConfig (horizon 40, 6 warm and 30
cold iterations) and for the defaults (horizon 100, 8 and 40) it prints
the largest |pole| angle, the largest over the last 20 steps and the
largest |cart| position of: the JAX MPC planning on relax_limits of the
plant, the JAX MPC planning on the plant itself (its full constrained
step), and the port's MPC (device="cpu", the plain versions of the
kernels) planning on relax_limits of the plant (the port cannot plan on
the limits yet: ROADMAP queue A, M4 (a)). chip_smoke.py phase 13 gates the
pole at the config where the relaxed planner balances it. Takes a few
minutes, most of it the port's eager loop at horizon 100.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nimblephysics_tpu.models import builders as jb  # noqa: E402
from nimblephysics_tpu.models.model import State as JState  # noqa: E402
from nimblephysics_tpu.models.model import relax_limits as jrelax  # noqa: E402
from nimblephysics_tpu.realtime.mpc import MPC as JMPC  # noqa: E402
from nimblephysics_tpu.realtime.mpc import MPCConfig as JMPCConfig  # noqa: E402
from nimblephysics_tpu.simulation.step import step as jstep  # noqa: E402

from nimblephysics_tpu_torch.models import builders  # noqa: E402
from nimblephysics_tpu_torch.models.model import State, relax_limits  # noqa: E402
from nimblephysics_tpu_torch.realtime import MPC, MPCConfig  # noqa: E402
from nimblephysics_tpu_torch.simulation.step import step  # noqa: E402
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost  # noqa: E402

DT, STEPS, EVERY = 0.02, 120, 5
CONFIGS = {"test_realtime.py's": dict(horizon=40, replan_iters=6, first_solve_iters=30),
           "the defaults": {}}


def jax_costs():
    def running(x, u, t):
        return 1.0 * x[1] ** 2 + 0.2 * x[0] ** 2 + 1e-4 * jnp.sum(u ** 2)

    def final(x):
        return 50.0 * x[1] ** 2 + 10.0 * x[0] ** 2 + 1.0 * jnp.sum(x[2:] ** 2)

    return running, final


def loop(mpc, state, plant_step, pole, cart):
    """tests/test_realtime.py's closed loop; (|pole| max, over the last 20
    steps, |cart| max)."""
    t = 0.0
    mpc.record_state(t, state)
    mpc.replan_at(t)
    poles, carts = [], []
    for i in range(STEPS):
        state = plant_step(state, mpc.control_now(t, state))
        t += DT
        mpc.record_state(t, state)
        if i % EVERY == 0:
            mpc.replan_at(t)
        poles.append(abs(pole(state)))
        carts.append(abs(cart(state)))
    return max(poles), max(poles[-20:]), max(carts)


def main() -> int:
    mj = jb.cartpole(dt=DT)
    jplant = jax.jit(lambda s, u: jstep(mj, s, u))
    mt = builders.cartpole(dt=DT, dtype=torch.float64, device="cpu")
    run = QuadraticCost(mt, wq=(0.2, 1.0), wu=1e-4)
    fin = QuadraticFinalCost(mt, wx=(10.0, 50.0, 1.0, 1.0))
    for name, kw in CONFIGS.items():
        for label, planner in (("JAX MPC, planner relax_limits", jrelax(mj)),
                               ("JAX MPC, planner with the limits", None)):
            t0 = time.perf_counter()
            mpc = JMPC(mj, *jax_costs(), JMPCConfig(**kw), planning_model=planner)
            res = loop(mpc, JState(q=jnp.asarray([0.0, 0.15]), v=jnp.zeros(2)), jplant,
                       lambda s: float(s.q[1]), lambda s: float(s.q[0]))
            print(f"{name} config {kw}: {label}: |pole| max {res[0]:.10f}, last 20 steps "
                  f"{res[1]:.10f}, |cart| max {res[2]:.10f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        t0 = time.perf_counter()
        mpc = MPC(mt, run, fin, MPCConfig(**kw), planning_model=relax_limits(mt), device="cpu")
        res = loop(mpc, State(q=torch.tensor([0.0, 0.15], dtype=torch.float64),
                              v=torch.zeros(2, dtype=torch.float64)),
                   lambda s, u: step(mt, s, u), lambda s: float(s.q[1]), lambda s: float(s.q[0]))
        print(f"{name} config {kw}: port MPC (plain path), planner relax_limits: |pole| max "
              f"{res[0]:.10f}, last 20 steps {res[1]:.10f}, |cart| max {res[2]:.10f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
