"""The port's first-order trajectory solvers and SSID against the JAX
package's, f64 on the CPU:

  * solve_single_shooting on the cartpole (T = 10, 20 iterations; on
    relax_limits of it: its limits are never reached there, and the JAX
    limit rows' direct solve doubles the JAX compile): "adam"; "sgd" with
    grad_clip; static_vars=("mass",); tune_start; one bounded constraint
    (the PHR outer loop) with grad_clip; and on the jump worm through its
    contact (T = 4, 3 iterations, Adam, grad_clip = 10): the decision
    variables and the loss history within rel 1e-8 of the JAX solve's;
  * solve_multiple_shooting on the relaxed cartpole (2 segments of 5
    steps, 2 outer rounds of 5 Adam steps), likewise; on the worm (2
    segments of 2 steps) the segments roll out as one batch, each step's
    LCPs of all segments in one call of K7's wrapper, with the states and
    gradients of the segments rolled one at a time;
  * SSID.identify_masses on tests/test_realtime.py's pendulum(2) data (its
    first 40 steps) at 30 iterations (not 300), and on the worm's contact
    at T = 6 with 3 iterations: masses and loss history within rel 1e-8.

One jitted JAX solve per case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.models.model import relax_limits as j_relax
from nimblephysics_tpu.realtime.ssid import SSID as JSSID
from nimblephysics_tpu.realtime.ssid import SSIDConfig as JSSIDConfig
from nimblephysics_tpu.trajectory import shooting as js

from nimblephysics_tpu_torch.models.model import State
from nimblephysics_tpu_torch.ops import cuda_lcp
from nimblephysics_tpu_torch.realtime import SSID, SSIDConfig
from nimblephysics_tpu_torch.simulation.step import rollout as p_rollout
from nimblephysics_tpu_torch.trajectory import (MultipleShootingProblem, SingleShootingProblem,
                                                solve_multiple_shooting, solve_single_shooting)
from nimblephysics_tpu_torch.trajectory.shooting import Trajectory

from torch_port_helpers import t64, to_port

RTOL = 1e-8


def close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def swing_loss(np_):
    """The final state to rest with small controls (jnp or torch)."""

    def loss(traj):
        return (10.0 * np_.sum(traj.q[-1] ** 2) + np_.sum(traj.v[-1] ** 2)
                + 1e-3 * np_.sum(traj.u ** 2))

    return loss


def effort(np_):
    return lambda traj: 1e-3 * np_.mean(traj.u ** 2)


def final_angle_sq(np_):
    return lambda traj: np_.mean(traj.q[-3:, 1] ** 2) + 0.1 * np_.mean(traj.v[-3:, 1] ** 2)


def worm_loss(np_):
    """bench.py's worm cost summed over the trajectory: 1e-5 |u|^2 + 2 (q1 +
    0.4)^2 per step, 20 (q1 + 0.4)^2 at the end."""

    def loss(traj):
        return (np_.sum(1e-5 * traj.u ** 2) + 2.0 * np_.sum((traj.q[:, 1] + 0.4) ** 2)
                + 20.0 * (traj.q[-1, 1] + 0.4) ** 2)

    return loss


def worm_state_loss(np_):
    """worm_loss plus 0.01 |x|^2 over the trajectory: every start-state
    variable of multiple shooting gets a gradient well above Adam's eps (a
    variable whose gradient is zero up to rounding would move by rounding
    over eps)."""

    def loss(traj):
        return worm_loss(np_)(traj) + 0.01 * (np_.sum(traj.q ** 2) + np_.sum(traj.v ** 2))

    return loss


CARTPOLE_X0 = np.array([0.0, 0.15, 0.0, 0.0])
# the worm's root box 0.1 mm over the floor and falling: contact from the
# first steps
WORM_X0 = np.array([0.0, -0.5249, 0.3, 0.6, 0.0, -0.2, 0.0, 0.0])

# name -> (model, x0, horizon, loss, problem options, solver options)
SINGLE_CASES = {
    "adam": ("relaxed", CARTPOLE_X0, 10, swing_loss, {}, dict(iters=20)),
    "sgd_grad_clip": ("relaxed", CARTPOLE_X0, 10, swing_loss, {},
                      dict(iters=20, optimizer="sgd", lr=0.05, grad_clip=1.0)),
    "static_mass": ("relaxed", CARTPOLE_X0, 10, swing_loss, dict(static_vars=("mass",)),
                    dict(iters=20, lr=0.05)),
    "tune_start": ("relaxed", CARTPOLE_X0, 10, swing_loss, dict(tune_start=True),
                   dict(iters=20, lr=0.05)),
    "constraint": ("relaxed", CARTPOLE_X0, 10, effort,
                   dict(constraints=((final_angle_sq, 0.0, 1e-3),)),
                   dict(iters=20, grad_clip=10.0)),
    "worm_contact": ("worm", WORM_X0, 4, worm_loss, {},
                     dict(iters=3, lr=1.0, grad_clip=10.0)),
}
# the worm starts from controls of std 5 (seeded): from u = 0 the later
# controls' gradients are ~1e-12, under Adam's eps, where a rounding-level
# gradient difference moves the update by rel ~1e-6
U_INIT = {"worm_contact": lambda: 5.0 * np.random.default_rng(2).standard_normal((4, 2))}


def jax_model(name):
    if name == "worm":
        return jb.jump_worm(dt=0.001)
    model = jb.cartpole(dt=0.02)
    return j_relax(model) if name == "relaxed" else model


def jx0(x):
    n = len(x) // 2
    return JState(q=jnp.asarray(x[:n]), v=jnp.asarray(x[n:]))


def px0(x):
    return State.from_flat(t64(x))


def port_single_problem(model, x0, horizon, loss, opts):
    opts = dict(opts)
    if "constraints" in opts:
        opts["constraints"] = tuple((fn(torch), lo, hi) for fn, lo, hi in opts["constraints"])
    return SingleShootingProblem(model=model, x0=px0(x0), horizon=horizon, loss=loss(torch),
                                 **opts)


def jax_single_problem(model, x0, horizon, loss, opts):
    opts = dict(opts)
    if "constraints" in opts:
        opts["constraints"] = tuple((fn(jnp), lo, hi) for fn, lo, hi in opts["constraints"])
    return js.SingleShootingProblem(model=model, x0=jx0(x0), horizon=horizon, loss=loss(jnp),
                                    **opts)


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_single_shooting_matches_jax(case):
    name, x0, T, loss, popts, sopts = SINGLE_CASES[case]
    jmodel = jax_model(name)
    jprob = jax_single_problem(jmodel, x0, T, loss, popts)
    u0 = U_INIT[case]() if case in U_INIT else np.zeros((T, jmodel.num_actions))
    ref = jax.jit(lambda u: js.solve_single_shooting(jprob, u_init=u, **sopts))(
        jnp.asarray(u0))
    model = to_port(jmodel)
    sol = solve_single_shooting(port_single_problem(model, x0, T, loss, popts),
                                u_init=t64(u0), device="cpu", **sopts)
    close(sol.u, ref.u)
    close(sol.loss_history, ref.loss_history)
    close(sol.loss, ref.loss)
    h = sol.loss_history.numpy()
    assert h.shape == (sopts["iters"] // (6 if "constraints" in popts else 1)
                       * (6 if "constraints" in popts else 1),)
    assert np.isfinite(h).all()
    if ref.params is not None:
        assert set(sol.params) == set(ref.params)
        for k in ref.params:
            close(sol.params[k], ref.params[k])
    if "constraints" in popts:
        close(sol.constraint_values, ref.constraint_values)
    if case != "constraint":
        assert h[-1] < h[0]


def test_multiple_shooting_matches_jax():
    """The relaxed cartpole, 2 segments of 5 steps, 2 rounds of 5 Adam
    steps, from seeded controls."""
    jmodel, S, L = jax_model("relaxed"), 2, 5
    opts = dict(outer_iters=2, inner_iters=5)
    jprob = js.MultipleShootingProblem(model=jmodel, x0=jx0(CARTPOLE_X0), num_segments=S,
                                       seg_len=L, loss=swing_loss(jnp))
    u_init = 0.3 * np.random.default_rng(3).standard_normal((S * L, 1))
    ref = jax.jit(lambda u: js.solve_multiple_shooting(jprob, u_init=u, **opts))(
        jnp.asarray(u_init))
    prob = MultipleShootingProblem(model=to_port(jmodel), x0=px0(CARTPOLE_X0), num_segments=S,
                                   seg_len=L, loss=swing_loss(torch))
    sol = solve_multiple_shooting(prob, u_init=t64(u_init), device="cpu", **opts)
    for f in ("u", "starts_q", "starts_v", "loss", "defect_norm", "loss_history"):
        close(getattr(sol, f), getattr(ref, f))
    assert sol.loss_history.shape == (10,) and float(sol.defect_norm) < 1.0


def test_worm_segments_roll_as_one_batch(monkeypatch):
    """The worm's multiple-shooting segments (2 of 2 steps) through its
    contact roll out as one batch of the step, each step's LCPs of all
    segments in one call of K7's wrapper, with the states and the gradient
    of a loss on them (the AL objective's shape) of the segments rolled one
    at a time (the unbatched rollout that test_single_shooting_matches_jax
    holds to the JAX package); then a solve calls the wrapper in that
    pattern: the chained start rollout one segment at a time, every later
    rollout all segments at once."""
    S, L = 2, 2
    model = to_port(jax_model("worm"))
    prob = MultipleShootingProblem(model=model, x0=px0(WORM_X0), num_segments=S, seg_len=L,
                                   loss=worm_state_loss(torch))
    rng = np.random.default_rng(3)
    starts = np.stack([WORM_X0, WORM_X0 + 1e-3 * rng.standard_normal(8)])
    u = 5.0 * rng.standard_normal((S, L, 2))
    calls = []
    wrapped = cuda_lcp.pgs_batched

    def pgs(A, b, *args, **kw):
        calls.append(tuple(b.shape))
        return wrapped(A, b, *args, **kw)

    monkeypatch.setattr(cuda_lcp, "pgs_batched", pgs)

    def value(sq, sv, u_, rolls):
        qs, vs, fq, fv = rolls(sq, sv, u_)
        traj = Trajectory(q=qs.reshape(S * L, 4), v=vs.reshape(S * L, 4),
                          u=u_.reshape(S * L, 2))
        return (worm_state_loss(torch)(traj)
                + torch.sum(prob.defects(sq, sv, fq, fv) ** 2)), (qs, vs, fq, fv)

    def one_at_a_time(sq, sv, u_):
        outs = [prob.segment_rollouts(sq[k], sv[k], u_[k]) for k in range(S)]
        return tuple(torch.stack(o) for o in zip(*outs))

    res = []
    for rolls in (prob.segment_rollouts, one_at_a_time):
        leaves = [t64(a).requires_grad_(True) for a in (starts[:, :4], starts[:, 4:], u)]
        calls.clear()
        val, outs = value(*leaves, rolls)
        val.backward()
        res.append((val, outs, [x.grad for x in leaves], list(calls)))
    assert res[0][3] == [(S, 28)] * L and res[1][3] == [(28,)] * (S * L)
    close(res[0][0], res[1][0].detach().numpy(), 1e-12)
    for got, want in zip(res[0][1] + tuple(res[0][2]), res[1][1] + tuple(res[1][2])):
        close(got, want.detach().numpy(), 1e-9)
    calls.clear()
    sol = solve_multiple_shooting(prob, u_init=t64(u), outer_iters=1, inner_iters=1, lr=0.1,
                                  device="cpu")
    assert calls == [(28,)] * (S * L) + [(S, 28)] * (3 * L)
    assert np.isfinite(sol.loss_history.numpy()).all() and sol.u.shape == (S * L, 2)


def test_shooting_refuses_a_model_off_its_device():
    model = to_port(jax_model("cartpole"))
    prob = port_single_problem(model, CARTPOLE_X0, 3, swing_loss, {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            solve_single_shooting(prob, iters=1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        solve_single_shooting(prob, iters=1, optimizer="lbfgs", device="cpu")
    with pytest.raises(ValueError, match="the model is on cpu, the computation on meta"):
        solve_single_shooting(prob, iters=1, device="meta")
    traj = prob.rollout_controls(torch.zeros(3, 1, dtype=torch.float64))
    assert isinstance(traj, Trajectory) and traj.q.shape == (3, 2)


def test_single_shooting_grad_clip_zeroes_a_non_finite_gradient():
    """The plain problem's grad_clip guards after the scale, as the JAX
    package's plain branch does: a NaN entry (0 * d sqrt(u)/du at u = 0)
    makes the norm NaN, and every entry is zeroed, so the controls stay
    where they started and finite."""
    model = to_port(jax_model("relaxed"))

    def loss(traj):
        return swing_loss(torch)(traj) + 0.0 * torch.sqrt(traj.u[0, 0])

    prob = SingleShootingProblem(model=model, x0=px0(CARTPOLE_X0), horizon=3, loss=loss)
    sol = solve_single_shooting(prob, iters=2, grad_clip=1.0, device="cpu")
    assert torch.equal(sol.u, torch.zeros(3, 1, dtype=torch.float64))
    assert torch.isfinite(sol.loss_history).all() and sol.loss_history[0] == sol.loss_history[1]


def pendulum_window():
    """tests/test_realtime.py's SSID data: pendulum(2) under seeded controls,
    the model's masses scaled by (1.6, 0.7); the first 40 of its 80 steps
    (the port's eager reverse pass takes ~0.5-1 s per 80-step iteration
    on a CPU)."""
    true = jb.pendulum(2, dt=0.01)
    rng = np.random.default_rng(0)
    q0, v0 = np.array([0.4, -0.2]), np.zeros(2)
    us = rng.standard_normal((80, 2)) * 2.0
    return true, true.mass * jnp.asarray([1.6, 0.7]), q0, v0, us[:40], 30


def worm_window():
    """The worm falling onto the floor under controls of std 5, masses
    scaled by seeded factors in [0.7, 1.4]."""
    true = jb.jump_worm(dt=0.001)
    rng = np.random.default_rng(4)
    us = 5.0 * rng.standard_normal((6, 2))
    scale = rng.uniform(0.7, 1.4, true.num_bodies)
    return true, true.mass * jnp.asarray(scale), WORM_X0[:4], WORM_X0[4:], us, 3


SSID_CASES = {"pendulum": pendulum_window, "worm": worm_window}


@pytest.mark.parametrize("case", list(SSID_CASES))
def test_ssid_matches_jax(case):
    true, wrong_mass, q0, v0, us, iters = SSID_CASES[case]()
    # the observed window from the port's rollout of the true model (the
    # same arrays go to both fits)
    with torch.no_grad():
        _, traj = p_rollout(to_port(true), px0(np.r_[q0, v0]), t64(us))
    obs_q, obs_v = traj.q.numpy(), traj.v.numpy()
    wrong = true.replace(mass=wrong_mass)
    cfg = dict(iters=iters, lr=0.05)
    ref = JSSID(wrong, JSSIDConfig(**cfg)).identify_masses(
        jnp.asarray(q0), jnp.asarray(v0), jnp.asarray(us), jnp.asarray(obs_q),
        jnp.asarray(obs_v))
    ssid = SSID(to_port(wrong), SSIDConfig(**cfg), device="cpu")
    masses, hist = ssid.identify_masses(q0, v0, us, obs_q, obs_v)
    close(masses, ref[0])
    close(hist, ref[1])
    assert hist.shape == (iters,) and float(hist[-1]) < float(hist[0])
    # moving toward the true masses
    m_true, m_wrong = np.asarray(true.mass), np.asarray(wrong_mass)
    assert np.abs(masses.numpy() - m_true).sum() < np.abs(m_wrong - m_true).sum()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SSID(to_port(wrong), SSIDConfig(**cfg))
