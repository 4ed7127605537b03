"""The port's line-search rollout (K2's plain version and its CPU dispatch)
against the JAX package's Pallas kernel in interpret mode on cartpole,
B=3, A=3, T=5, with bench.py's costs (QuadraticCost on the port's side)
and torque limits that clip some controls, 1e-10 in f64."""

import jax.numpy as jnp
import numpy as np
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import relax_limits as jrelax
from nimblephysics_tpu.ops.pallas_rollout import rollout_gains_pallas

from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_gains

from torch_port_helpers import jax_cartpole_costs, port_cartpole_costs, t64, to_port

B, A, T = 3, 3, 5


def test_rollout_gains_matches_pallas():
    # torque limits of +-2: some controls are clipped, some are not
    tau_limit = 2.0
    mj = jrelax(jb.cartpole(dt=0.02))
    mj = mj.replace(tau_lower=jnp.full_like(mj.tau_lower, -tau_limit),
                    tau_upper=jnp.full_like(mj.tau_upper, tau_limit))
    mt = to_port(mj)
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-0.3, 0.3, (B, 4))
    xs_ref = rng.uniform(-0.3, 0.3, (B, T + 1, 4))
    u_ref = rng.standard_normal((B, T, 1))
    K = 0.5 * rng.standard_normal((B, T, 1, 4))
    k = rng.standard_normal((B, T, 1))
    alphas = np.array([1.0, 0.3, 0.01])
    run_j, fin_j = jax_cartpole_costs(mj.nq)
    xs_j, us_j, c_j = rollout_gains_pallas(
        mj, run_j, fin_j, *map(jnp.asarray, (x0, xs_ref, u_ref, K, k, alphas)), block_b=128)
    run_t, fin_t = port_cartpole_costs(mt)
    xs_t, us_t, c_t = rollout_gains(mt, run_t, fin_t, *map(t64, (x0, xs_ref, u_ref, K, k, alphas)))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-10, atol=1e-10)
    clipped = us_t.abs() == tau_limit
    assert bool(clipped.any()) and not bool(clipped.all())


def test_rollout_gains_takes_any_cost_on_cpu():
    """On CPU tensors the plain version evaluates any per-point callable."""
    mj = jrelax(jb.cartpole(dt=0.02))
    mt = to_port(mj)
    run_q, fin_q = port_cartpole_costs(mt)

    def run_fn(x, u, t):
        return 0.1 * torch.sum(x[:2] ** 2) + 1e-3 * torch.sum(u ** 2)

    def fin_fn(x):
        return 10.0 * torch.sum(x ** 2)

    rng = np.random.default_rng(5)
    args = [t64(a) for a in (rng.uniform(-0.3, 0.3, (2, 4)), np.zeros((2, T + 1, 4)),
                             rng.standard_normal((2, T, 1)), np.zeros((2, T, 1, 4)),
                             np.zeros((2, T, 1)), np.ones(1))]
    _, _, c_q = rollout_gains(mt, run_q, fin_q, *args)
    _, _, c_f = rollout_gains(mt, run_fn, fin_fn, *args)
    np.testing.assert_allclose(c_f.numpy(), c_q.numpy(), rtol=1e-12)
