"""The port's ops/lane_chain.py (its plain versions, which the CPU runs)
against the JAX package's chained kernels, on the jump worm:

  * chained_linearize_vjp (K8): in f32 against the JAX chained_linearize_vjp
    in interpret mode at budget=8000 (several primal and tangent chunks),
    PCG depth 12, rel 2e-4; in f64 against jax.jacrev of the v' half of the
    JAX dyn_frozen_for_trace, rel 1e-9 (the JAX chain packs every chunk
    boundary in f32, so it is held in f32 only);
  * chained_step_rollout (K9): in f32 against the JAX chained_step_rollout
    in interpret mode at the same budget, controls beyond the worm's +-100
    torque limits included, rel 2e-4; in f64 against a jax.lax.scan of the
    JAX frozen step on the clipped controls, rel 1e-9, at PCG depths 1 and
    2 (friction rows ride the cone at these points, where deeper PCGs
    amplify rounding);
  * that K9 clips each control before its step, as the JAX chain's step
    function does, and takes the running cost on the controls as given;
  * the wrappers' CPU dispatch and refusals.

Points: tests/test_torch_worm_kernels.py's eight worm states (in floor
contact, moving down and sliding) with their classes from the port's
classify_points, as B=2 worlds of T=2 steps for K8 and as two start states
for K9. Each JAX reference is computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.ops.lane_chain import chained_linearize_vjp as j_chained_vjp
from nimblephysics_tpu.ops.lane_chain import chained_step_rollout as j_chained_rollout
from nimblephysics_tpu.ops.pallas_linearize import dyn_frozen_for_trace as j_dyn_frozen

from nimblephysics_tpu_torch.ops import frozen_contact as tf
from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_gains_plain
from nimblephysics_tpu_torch.ops.lane_chain import (
    chained_linearize_vjp,
    chained_linearize_vjp_plain,
    chained_step_rollout,
    chained_step_rollout_plain,
)
from nimblephysics_tpu_torch.trajectory.costs import QuadraticFinalCost

from test_torch_worm import worm_states
from test_torch_worm_kernels import jax_rows
from torch_port_helpers import t64, to_port

B, T = 2, 2
CG = 12               # bench.py's planner PCG depth
CG_CONE = (1, 2)      # PCG depths where the cone points do not amplify rounding
BUDGET = 8000         # several chunks per chain on the worm
U_LIMIT = 100.0       # the worm's torque limits


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def j_running(x, u, t):
    return 1e-5 * jnp.sum(u ** 2) + 2.0 * (x[1] + 0.4) ** 2


def t_running(x, u, t):
    """The same running cost as a plain torch callable (K9 takes any)."""
    return 1e-5 * (u * u).sum(-1) + 2.0 * (x[..., 1] + 0.4) ** 2


@pytest.fixture(scope="module")
def pts():
    mj = jb.jump_worm(dt=0.001)
    mt = to_port(mj)
    q, v, u = (a[:B * T] for a in worm_states(8, seed=23))
    x = np.concatenate([q, v], axis=1)
    cl, _ = tf.classify_points(mt, t64(x), mt.action_to_tau(t64(u)))
    cm, us = cl.cmask.numpy(), cl.us.numpy()
    assert cm[:, :24].any() and (us != 0).any()
    # K9: two start states, controls that pass the torque limits at some steps
    u_roll = 60.0 * np.random.default_rng(5).standard_normal((B, T, 2))
    u_roll[0, 0, 0], u_roll[1, 1, 1] = 150.0, -260.0
    assert np.abs(u_roll).max() > U_LIMIT
    return dict(mj=mj, mt=mt, x=x, u=u, cm=cm, us=us, x0=x[:B], u_roll=u_roll,
                cm_bt=cm.reshape(B, T, -1), us_bt=us.reshape(B, T, -1))


def f32_model(mj):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, mj)


@pytest.fixture(scope="module")
def jax_chain(pts):
    """The JAX chained kernels in f32, interpret mode, budget 8000, each
    under jax.jit (its interpret-mode kernels traced into one program)."""
    m32 = f32_model(pts["mj"])
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    cl = (f32(pts["cm_bt"]), f32(pts["us_bt"]))
    fx, fu = jax.jit(lambda xs, u, cl: j_chained_vjp(m32, xs, u, cl, cg_iters=CG,
                                                      budget=BUDGET))(
        f32(pts["x"].reshape(B, T, -1)), f32(pts["u"].reshape(B, T, -1)), cl)
    roll = jax.jit(lambda x0, u, cl: j_chained_rollout(m32, j_running, x0, u, cl,
                                                        cg_iters=CG_CONE[-1], budget=BUDGET))(
        f32(pts["x0"]), f32(pts["u_roll"]), cl)
    return dict(fx=np.asarray(fx), fu=np.asarray(fu), xs=np.asarray(roll[0]),
                cost=np.asarray(roll[1]))


@pytest.fixture(scope="module")
def frozen_scan(pts):
    """jax.lax.scan of the JAX frozen step on the clipped controls, f64,
    at each depth of CG_CONE, with the running cost on the given controls."""
    mj = pts["mj"]

    def roll(x0, u, cm, us):
        out = {}
        for cg in CG_CONE:
            dyn = jax.vmap(j_dyn_frozen(mj, cg_iters=cg))

            def body(x, inp):
                u_t, cm_t, us_t, t = inp
                c = jax.vmap(j_running, in_axes=(0, 0, None))(x, u_t, t)
                return dyn(x, jnp.clip(u_t, -U_LIMIT, U_LIMIT), cm_t, us_t), (x, c)

            xT, (xs, cs) = jax.lax.scan(body, x0, (u.swapaxes(0, 1), cm.swapaxes(0, 1),
                                                   us.swapaxes(0, 1), jnp.arange(T)))
            out[cg] = (jnp.concatenate([xs, xT[None]], axis=0).swapaxes(0, 1), cs.sum(0))
        return out

    res = jax.jit(roll)(*(jnp.asarray(pts[k]) for k in ("x0", "u_roll", "cm_bt", "us_bt")))
    return {cg: tuple(np.asarray(a) for a in v) for cg, v in res.items()}


def port_k8(pts, dtype):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    mt = pts["mt"] if dtype == torch.float64 else to_port(pts["mj"], dtype=torch.float32)
    return chained_linearize_vjp(mt, t(pts["x"].reshape(B, T, -1)), t(pts["u"].reshape(B, T, -1)),
                                 (t(pts["cm_bt"]), t(pts["us_bt"])), cg_iters=CG, budget=BUDGET)


def port_k9(pts, dtype, cg):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    mt = pts["mt"] if dtype == torch.float64 else to_port(pts["mj"], dtype=torch.float32)
    return chained_step_rollout(mt, t_running, t(pts["x0"]), t(pts["u_roll"]),
                                (t(pts["cm_bt"]), t(pts["us_bt"])), cg_iters=cg, budget=BUDGET)


def test_chained_linearize_vjp_matches_jax_chain_f32(pts, jax_chain):
    fx, fu = port_k8(pts, torch.float32)
    close(fx, jax_chain["fx"], 2e-4)
    close(fu, jax_chain["fu"], 2e-4)


def test_chained_linearize_vjp_matches_jacrev_f64(pts):
    fx, fu = port_k8(pts, torch.float64)
    gx, gu = jax_rows(pts, CG, "rev")
    close(fx[:, :, 4:].reshape(B * T, 4, 8), gx, 1e-9)
    close(fu[:, :, 4:].reshape(B * T, 4, 2), gu, 1e-9)
    dt = float(pts["mt"].dt)
    top = np.concatenate([np.eye(4), dt * np.eye(4)], axis=1)
    np.testing.assert_array_equal(fx[:, :, :4].numpy(), np.broadcast_to(top, (B, T, 4, 8)))
    np.testing.assert_array_equal(fu[:, :, :4].numpy(), 0.0)


def test_chained_step_rollout_matches_jax_chain_f32(pts, jax_chain):
    xs, cost = port_k9(pts, torch.float32, CG_CONE[-1])
    close(xs, jax_chain["xs"], 2e-4)
    close(cost, jax_chain["cost"], 2e-4)


@pytest.mark.parametrize("cg", CG_CONE)
def test_chained_step_rollout_matches_frozen_scan_f64(pts, frozen_scan, cg):
    xs, cost = port_k9(pts, torch.float64, cg)
    close(xs, frozen_scan[cg][0], 1e-9)
    close(cost, frozen_scan[cg][1], 1e-9)


def test_chained_step_rollout_clips_the_step_not_the_cost(pts):
    """Each step takes the control clipped to the torque limits: the states
    are K2's rollout at one alpha with zero gains (which clips) bit for bit,
    and differ from a rollout on the unclipped controls. The running cost
    takes the controls as given, so it differs from the cost of the clipped
    ones."""
    mt, cg = pts["mt"], CG_CONE[-1]
    x0, u = t64(pts["x0"]), t64(pts["u_roll"])
    cl = (t64(pts["cm_bt"]), t64(pts["us_bt"]))
    xs, cost = chained_step_rollout(mt, t_running, x0, u, cl, cg_iters=cg)
    zero_final = QuadraticFinalCost(mt)
    xs2, us2, _ = rollout_gains_plain(mt, t_running, zero_final, x0,
                                      torch.zeros(B, T + 1, 8, dtype=torch.float64), u,
                                      torch.zeros(B, T, 2, 8, dtype=torch.float64),
                                      torch.zeros(B, T, 2, dtype=torch.float64),
                                      torch.ones(1, dtype=torch.float64), classes=cl,
                                      cg_iters=cg)
    assert torch.equal(xs, xs2[0])
    assert float(us2.abs().max()) == U_LIMIT
    wide = mt.replace(tau_lower=torch.full_like(mt.tau_lower, -1e6),
                      tau_upper=torch.full_like(mt.tau_upper, 1e6))
    xs_wide, _ = chained_step_rollout_plain(wide, t_running, x0, u, cl, cg_iters=cg)
    assert float((xs_wide - xs).abs().max()) > 1e-4
    ts = torch.arange(T).repeat(B)
    clipped = torch.func.vmap(t_running)(xs[:, :-1].reshape(B * T, 8),
                                         us2[0].reshape(B * T, 2), ts).reshape(B, T).sum(1)
    assert float((clipped - cost).abs().max()) > 1e-3


def test_lane_chain_wrappers_dispatch_and_refuse(pts):
    mt = pts["mt"]
    xs, u = t64(pts["x"].reshape(B, T, -1)), t64(pts["u"].reshape(B, T, -1))
    cl = (t64(pts["cm_bt"]), t64(pts["us_bt"]))
    before = (chained_linearize_vjp.launches, chained_step_rollout.launches)
    for a, b in zip(chained_linearize_vjp(mt, xs, u, cl, cg_iters=2),
                    chained_linearize_vjp_plain(mt, xs, u, cl, 2)):
        assert torch.equal(a, b)
    for a, b in zip(chained_step_rollout(mt, t_running, t64(pts["x0"]), u, cl, cg_iters=2),
                    chained_step_rollout_plain(mt, t_running, t64(pts["x0"]), u, cl, 2)):
        assert torch.equal(a, b)
    assert (chained_linearize_vjp.launches, chained_step_rollout.launches) == before
    with pytest.raises(ValueError, match="shape"):
        chained_linearize_vjp(mt, xs[..., :6].contiguous(), u, cl)
    with pytest.raises(ValueError, match="shape"):
        chained_step_rollout(mt, t_running, t64(pts["x0"]), u, (cl[0][..., :27].contiguous(), cl[1]))
    with pytest.raises(RuntimeError, match="forward-only"):
        chained_step_rollout(mt, t_running, t64(pts["x0"]).requires_grad_(True), u, cl)
