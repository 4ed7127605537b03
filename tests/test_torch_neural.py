"""The port's gradient oracles (nimblephysics_tpu_torch/neural) against the
JAX package's, f64 on the CPU:

  * step_jacobians on tests/test_neural.py's cartpole and on its jump worm
    resting on the floor (contact rows clamping): all six Jacobians within
    rel 1e-9 of the JAX ones; a finite-difference twin of vel_vel on the
    worm at that test's atol 5e-5; a batch of 4 worm states equal to the
    four single calls;
  * backprop_state: the cartpole within rel 1e-10 of jax.vjp; the ball of
    tests/test_saddlepoint.py (a sphere on a halfspace, carried across by
    models/convert.py) in its five calls, within rel 1e-9 of JAX and at the
    reference's numbers (-0.2 dt, -0.1 dt^2) at rel 1e-6; the worm with the
    explore flag within rel 1e-9, at pairs of which some choose the
    overridden classes' direction, the same ones as in JAX;
  * mappings: pendulum(3)'s map_positions, jacobian and map_velocities
    within rel 1e-12, ik_solve on pendulum(4), and logm_so3's gradient
    finite and within rel 1e-9 of JAX at the near-pi inputs of
    tests/regression/test_logm_near_pi_gradients.py.

One jitted JAX reference per case."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import ShapeSpec as JShapeSpec
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.models.model import build_model as j_build_model
from nimblephysics_tpu.neural import IKMapping as JIKMapping
from nimblephysics_tpu.neural import backprop_state as j_backprop_state
from nimblephysics_tpu.neural import ik_solve as j_ik_solve
from nimblephysics_tpu.neural import step_jacobians as j_step_jacobians
from nimblephysics_tpu.neural.mappings import marker_positions as j_marker_positions
from nimblephysics_tpu.ops import lie as jlie
from nimblephysics_tpu.ops.lie import Transform as JTransform
from nimblephysics_tpu.simulation.step import rollout as j_rollout

from nimblephysics_tpu_torch.models.model import State
from nimblephysics_tpu_torch.neural import (IKMapping, StepJacobians, backprop_state,
                                            ik_solve, marker_positions, step_jacobians)
from nimblephysics_tpu_torch.ops import cuda_lcp
from nimblephysics_tpu_torch.ops import lie
from nimblephysics_tpu_torch.ops.collide import detect_contacts
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.simulation.step import step
from nimblephysics_tpu_torch.utils.fd import fd_jacobian

from torch_port_helpers import t64, to_port


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def jstate(x):
    return JState(q=jnp.asarray(x[: len(x) // 2]), v=jnp.asarray(x[len(x) // 2:]))


def pstate(x):
    x = t64(x)
    return State.from_flat(x)


# ------------------------------------------------------------- step_jacobians

def cartpole_case():
    model = jb.cartpole(dt=0.02)
    return model, np.array([0.1, 0.3, -0.2, 0.4]), np.array([0.7])


def worm_case():
    """tests/test_neural.py's worm: 400 passive steps from the air, then the
    first link's velocity set to 1."""
    model = jb.jump_worm(dt=0.002)
    s_air = JState(q=jnp.zeros(4).at[2].set(1.2).at[3].set(1.2), v=jnp.zeros(4))
    s0, _ = jax.jit(lambda s: j_rollout(model, s, jnp.zeros((400, 2))))(s_air)
    x = np.concatenate([np.asarray(s0.q), np.asarray(s0.v)])
    x[4 + 2] = 1.0
    return model, x, np.array([5.0, -3.0])


JAC_CASES = {"cartpole": cartpole_case, "worm": worm_case}


@functools.lru_cache(maxsize=None)
def _jac_case(name):
    jmodel, x, a = JAC_CASES[name]()
    ref = jax.jit(lambda x_, a_: j_step_jacobians(jmodel, jstate(x_), a_))(
        jnp.asarray(x), jnp.asarray(a))
    return dict(name=name, jmodel=jmodel, model=to_port(jmodel), x=x, a=a,
                ref=[np.asarray(r) for r in ref])


@pytest.fixture(scope="module", params=list(JAC_CASES))
def jac_case(request):
    return _jac_case(request.param)


@pytest.fixture(scope="module")
def worm():
    return _jac_case("worm")


def test_step_jacobians_match_jax(jac_case):
    model = jac_case["model"]
    cuda_lcp.pgs_batched.launches = 0
    J = step_jacobians(model, pstate(jac_case["x"]), t64(jac_case["a"]))
    assert isinstance(J, StepJacobians)
    for got, want in zip(J, jac_case["ref"]):
        close(got, want, 1e-9)
    if jac_case["name"] == "worm":
        # the worm rests on the floor: its LCP has clamping contact rows
        x = pstate(jac_case["x"])
        kin = dyn.forward_kinematics(model, x.q)
        assert bool(detect_contacts(model, kin.T_wb).active.any())
    # velPos is dt I under the parallel position update
    close(J.vel_pos, float(model.dt) * np.eye(model.nq), 1e-12)


def test_step_jacobians_vel_vel_fd_twin(worm):
    """tests/test_neural.py's FD twin of vel_vel through the contact."""
    model, x, a = worm["model"], worm["x"], t64(worm["a"])
    nq = model.nq
    J = step_jacobians(model, pstate(x), a)

    def fv(v):
        s = State(t64(x[:nq]), t64(v))
        return step(model, s, a).v.numpy()

    J_fd = fd_jacobian(fv, x[nq:], eps=1e-7)
    np.testing.assert_allclose(J.vel_vel.numpy(), J_fd, atol=5e-5)


def counting_pgs(monkeypatch):
    """Record the LCP batch shape of every call of K7's wrapper (which on CPU
    tensors runs its plain version and counts no launch)."""
    calls = []
    wrapped = cuda_lcp.pgs_batched

    def pgs(A, b, *args, **kw):
        calls.append(tuple(b.shape))
        return wrapped(A, b, *args, **kw)

    monkeypatch.setattr(cuda_lcp, "pgs_batched", pgs)
    return calls


def test_step_jacobians_batch_equals_singles(jac_case, monkeypatch):
    """A batch of 4 states gives the four single calls' Jacobians; on the
    worm its LCPs go to K7's wrapper in one call of the whole batch."""
    model, x, a = jac_case["model"], jac_case["x"], t64(jac_case["a"])
    nq = model.nq
    xs = np.stack([x + 0.002 * k * np.r_[np.ones(nq), -np.ones(nq)] for k in range(4)])
    calls = counting_pgs(monkeypatch)
    Jb = step_jacobians(model, pstate(xs), a)
    if jac_case["name"] == "worm":
        assert calls == [(4, 28)]
    for k in range(4):
        Jk = step_jacobians(model, pstate(xs[k]), a)
        for got, want in zip(Jb, Jk):
            assert got.shape[0] == 4
            close(got[k], want.numpy(), 1e-9)


# ------------------------------------------------------------- backprop_state

def test_backprop_state_cartpole_matches_jax_vjp():
    jmodel = jb.cartpole(dt=0.02)
    x, a, g = np.array([0.05, -0.2, 0.3, 0.1]), np.array([1.5]), np.array([1.0, -2.0, 0.5, 0.25])
    ref = jax.jit(lambda x_, a_, g_: j_backprop_state(jmodel, jstate(x_), a_, g_))(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(g))
    gx, ga = backprop_state(to_port(jmodel), pstate(x), t64(a), t64(g))
    close(gx, ref[0], 1e-10)
    close(ga, ref[1], 1e-10)


def ball_on_ground(dt=0.01):
    """tests/test_saddlepoint.py's ball: a 1-dof prismatic sphere (r = 0.5)
    over a frictionless floor."""
    joints = [dict(type="prismatic", name="ball_y", body_name="ball", parent=-1,
                   axes=[[0.0, 1.0, 0.0]], mass=1.0)]
    eye = JTransform(np.eye(3), np.zeros(3))
    shapes = (
        JShapeSpec(kind="sphere", body_index=0, offset=eye,
                   params=jnp.asarray([0.5, 0.0, 0.0, 0.0]), friction=jnp.asarray(0.0)),
        JShapeSpec(kind="halfspace", body_index=-1, offset=eye,
                   params=jnp.asarray([0.0, 1.0, 0.0, 0.0]), friction=jnp.asarray(0.0)),
    )
    return j_build_model(joints, dt=dt, shapes=shapes)


RESTING = np.array([0.5 - 1e-4, -1e-4])
G1 = np.array([-0.1, 0.0])
# (state, cotangent, explore): the four calls of
# test_explore_alternate_strategies_escapes_blocked_contact (the chained
# cotangent is the first call's gx), and the free fall of the second test
BALL_CASES = {
    "blocked": (RESTING, "g1", False),
    "blocked_chained": (RESTING, "g2", False),
    "explore": (RESTING, "g1", True),
    "explore_chained": (RESTING, "g2", True),
    "explore_free_fall": (np.array([1.5, 0.0]), np.array([-0.1, -0.3]), True),
}


@pytest.fixture(scope="module")
def ball():
    jmodel = ball_on_ground()
    fns = {flag: jax.jit(lambda x_, a_, g_, flag=flag: j_backprop_state(
        jmodel, jstate(x_), a_, g_, explore_alternate_strategies=flag)) for flag in (False, True)}
    a = jnp.zeros(jmodel.num_actions)
    g2 = np.asarray(fns[False](jnp.asarray(RESTING), a, jnp.asarray(G1))[0])
    return dict(jmodel=jmodel, model=to_port(jmodel), fns=fns, g2=g2)


@pytest.mark.parametrize("case", list(BALL_CASES))
def test_saddle_point_escape_matches_jax(ball, case):
    x, g, explore = BALL_CASES[case]
    g = {"g1": G1, "g2": ball["g2"]}.get(g, g) if isinstance(g, str) else g
    model = ball["model"]
    assert model.shapes[0].kind == "sphere"
    dt = float(model.dt)
    a = np.zeros(model.num_actions)
    ref = ball["fns"][explore](jnp.asarray(x), jnp.asarray(a), jnp.asarray(g))
    gx, ga = backprop_state(model, pstate(x), t64(a), t64(g),
                            explore_alternate_strategies=explore)
    close(gx, ref[0], 1e-9)
    close(ga, ref[1], 1e-9)
    if case in ("blocked", "explore"):
        np.testing.assert_allclose(float(gx[0]), -0.1, rtol=1e-9)
        np.testing.assert_allclose(float(gx[1]), -0.1 * dt, rtol=1e-9)
    if case in ("blocked", "blocked_chained", "explore"):
        # the clamping contact annihilates the control direction
        np.testing.assert_allclose(ga.numpy(), 0.0, atol=1e-8)
    if case == "explore_chained":
        # the reference's numbers: lossWrtVel = -0.2 dt, lossWrtTorque = -0.1 dt^2
        np.testing.assert_allclose(float(gx[1]), -0.2 * dt, rtol=1e-6)
        np.testing.assert_allclose(float(ga[0]), -0.1 * dt * dt, rtol=1e-6)


def test_ball_sphere_halfspace_contact_matches_jax(ball):
    """The sphere/halfspace narrow phase: the slot's point, normal and depth
    against the JAX package's, resting and in the air."""
    from nimblephysics_tpu.ops import dynamics as jdyn
    from nimblephysics_tpu.ops.collide import detect_contacts as j_detect

    jmodel, model = ball["jmodel"], ball["model"]
    for q in (RESTING[:1], np.array([1.5])):
        ref = j_detect(jmodel, jdyn.forward_kinematics(jmodel, jnp.asarray(q)).T_wb)
        got = detect_contacts(model, dyn.forward_kinematics(model, t64(q)).T_wb)
        for f in ("point", "normal", "depth", "active"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                       rtol=1e-14, atol=1e-15)


def took_alternate(res, plain, rtol=0.0):
    """Per state, whether the explore flag's result is not the plain
    gradient (beyond rtol of the plain one's largest entry), i.e. the
    overridden classes' direction was chosen."""
    out = False
    for r, p in zip(res, plain):
        r, p = np.asarray(r), np.asarray(p)
        out = out | (np.abs(r - p) > rtol * np.abs(p).max(-1, keepdims=True)).any(-1)
    return out


def test_backprop_state_worm_explore_matches_jax(worm):
    """The worm resting on the floor with the explore flag, at 32 seeded
    (action, cotangent) pairs as one batch: the result within rel 1e-9 of
    the JAX package's (one call per pair); some pairs, not all, choose the
    overridden classes' direction, and JAX chooses it at the same pairs
    (its result there is not the plain gradient, elsewhere it is within
    rounding)."""
    jmodel, x = worm["jmodel"], worm["x"]
    rng = np.random.default_rng(5)
    n = 32
    xs = np.broadcast_to(x, (n, x.shape[0])).copy()
    a, g = 5.0 * rng.standard_normal((n, 2)), rng.standard_normal((n, 8))
    # the second half loads the base's horizontal velocity, which the feet's
    # static friction blocks: there the overridden classes' direction wins
    g[n // 2:] *= 0.1
    g[n // 2:, 4] = np.sign(g[n // 2:, 4])
    fn = jax.jit(lambda x_, a_, g_: j_backprop_state(
        jmodel, jstate(x_), a_, g_, explore_alternate_strategies=True))
    ref = [np.stack(r) for r in zip(*(fn(jnp.asarray(x), jnp.asarray(a[k]), jnp.asarray(g[k]))
                                      for k in range(n)))]
    got = {flag: backprop_state(worm["model"], pstate(xs), t64(a), t64(g),
                                explore_alternate_strategies=flag) for flag in (False, True)}
    alt = took_alternate(got[True], got[False])
    assert alt.any() and not alt.all()
    np.testing.assert_array_equal(took_alternate(ref, got[False], rtol=1e-6), alt)
    close(got[True][0], ref[0], 1e-9)
    close(got[True][1], ref[1], 1e-9)


# ------------------------------------------------------------------- mappings

def test_ik_mapping_matches_jax():
    jmodel = jb.pendulum(3)
    entries = (("linear", 2), ("com", -1), ("angular", 1), ("spatial", 2))
    jmap = JIKMapping(model=jmodel, entries=entries)
    pmap = IKMapping(model=to_port(jmodel), entries=entries)
    q, v = np.array([0.3, -0.5, 0.8]), np.array([0.1, 0.2, -0.3])
    ref = jax.jit(lambda q_, v_: (jmap.map_positions(q_), jmap.jacobian(q_),
                                  jmap.map_velocities(q_, v_)))(jnp.asarray(q), jnp.asarray(v))
    assert pmap.out_dim == jmap.out_dim == 15
    close(pmap.map_positions(t64(q)), ref[0], 1e-12)
    close(pmap.jacobian(t64(q)), ref[1], 1e-12)
    close(pmap.map_velocities(t64(q), t64(v)), ref[2], 1e-12)
    # IK through the mapping recovers a reachable target
    target = pmap.map_positions(t64([0.5, -0.2, 0.4]))[:6]
    lin = IKMapping(model=pmap.model, entries=entries[:2])
    q_sol = lin.inverse_positions(target, torch.zeros(3, dtype=torch.float64), iters=100)
    np.testing.assert_allclose(lin.map_positions(q_sol).numpy(), target.numpy(), atol=1e-5)


def test_ik_solve_and_markers_match_jax():
    jmodel = jb.pendulum(4)
    model = to_port(jmodel)
    off = np.array([0.0, -1.0, 0.0])
    q_true = np.array([0.4, 0.3, -0.6, 0.2])

    def jtip(q):
        return j_marker_positions(jmodel, q, [(3, jnp.asarray(off))])[0]

    def tip(q):
        return marker_positions(model, q, [(3, t64(off))])[0]

    target = np.asarray(jtip(jnp.asarray(q_true)))
    ref = jax.jit(lambda t: j_ik_solve(jtip, t, jnp.zeros(4), iters=40))(jnp.asarray(target))
    close(tip(t64(q_true)), target, 1e-12)
    q_sol = ik_solve(tip, t64(target), torch.zeros(4, dtype=torch.float64), iters=40)
    close(q_sol, ref, 1e-9)
    np.testing.assert_allclose(tip(q_sol).numpy(), target, atol=1e-4)


def test_logm_so3_gradient_near_pi_matches_jax():
    axis = np.array([0.3, -0.5, 0.81])
    axis = axis / np.linalg.norm(axis)
    angles = np.array([np.pi - 1e-4, np.pi - 1e-6, np.pi, np.pi + 1e-6, 1.3])

    def jf(theta):
        return jnp.sum(jlie.logm_so3(jlie.expm_so3(jnp.asarray(axis) * theta)) ** 2)

    ref = jax.jit(jax.vmap(jax.grad(jf)))(jnp.asarray(angles))

    def f(theta):
        return torch.sum(lie.logm_so3(lie.expm_so3(t64(axis) * theta)) ** 2)

    for k, ang in enumerate(angles):
        th = torch.tensor(ang, dtype=torch.float64, requires_grad=True)
        f(th).backward()
        assert np.isfinite(float(th.grad)), ang
        close(th.grad, np.asarray(ref[k]), 1e-9)
    # the identity's neighbourhood, by reverse and forward mode
    w = t64([1e-9, -1e-9, 1e-9])
    g0 = torch.func.grad(lambda w_: torch.sum(lie.logm_so3(lie.expm_so3(w_)) ** 2))(w)
    ref0 = jax.jit(jax.grad(lambda w_: jnp.sum(jlie.logm_so3(jlie.expm_so3(w_)) ** 2)))(
        jnp.asarray(w))
    assert np.isfinite(g0.numpy()).all()
    close(g0, ref0, 1e-9)
    close(lie.vee(lie.hat(t64([0.1, -0.2, 0.3]))), [0.1, -0.2, 0.3], 0.0)
