"""The port's serving edge (nimblephysics_tpu_torch/realtime) against the
JAX package's, f64 on the CPU: control-plan indexing and gain feedback;
estimate_state_at on the cartpole with its limits (the plant's full
constrained step); the port's MPC against the JAX MPC, both planning on
relax_limits of the limited cartpole, through a cold replan and two warm
replans between plant steps (u, x_ref and K at rel = abs = 1e-9, as
tests/test_torch_ilqr.py holds the solvers); AsyncMPC on the port alone;
and the entry point's refusals. Horizon 10, 3 cold and 2 warm iterations;
one JAX MPC per module."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.models.model import relax_limits as jrelax
from nimblephysics_tpu.realtime import buffer as jbuf
from nimblephysics_tpu.realtime.mpc import MPC as JMPC
from nimblephysics_tpu.realtime.mpc import MPCConfig as JMPCConfig

from nimblephysics_tpu_torch.models.model import State, relax_limits
from nimblephysics_tpu_torch.realtime import (MPC, AsyncMPC, ControlPlan, MPCConfig, Ticker,
                                              control_at, estimate_state_at, plan_index)
from nimblephysics_tpu_torch.simulation.step import step
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost

from torch_port_helpers import t64, to_port

H, COLD, WARM = 10, 3, 2
DT = 0.02
TOL = 1e-9


def jax_costs():
    """tests/test_realtime.py's cartpole costs."""

    def running(x, u, t):
        return 1.0 * x[1] ** 2 + 0.2 * x[0] ** 2 + 1e-4 * jnp.sum(u ** 2)

    def final(x):
        return 50.0 * x[1] ** 2 + 10.0 * x[0] ** 2 + 1.0 * jnp.sum(x[2:] ** 2)

    return running, final


def port_costs(model):
    """The same costs as QuadraticCost / QuadraticFinalCost."""
    return (QuadraticCost(model, wq=(0.2, 1.0), wu=1e-4),
            QuadraticFinalCost(model, wx=(10.0, 50.0, 1.0, 1.0)))


def port_mpc(mt, **kw):
    return MPC(mt, *port_costs(mt), MPCConfig(horizon=H, replan_iters=WARM,
                                              first_solve_iters=COLD),
               planning_model=relax_limits(mt), device="cpu", **kw)


@pytest.fixture(scope="module")
def loop():
    """One plant (the port's, the limited cartpole from q = (0, 0.15))
    observed by both MPCs: a cold replan at t = 0, then after each of two
    plant steps a warm replan half a step later (so each estimates the
    state one step ahead of its observation). Returns both sides' plans."""
    mj = jb.cartpole(dt=DT)
    mt = to_port(mj)
    jmpc = JMPC(mj, *jax_costs(), JMPCConfig(horizon=H, replan_iters=WARM,
                                             first_solve_iters=COLD),
                planning_model=jrelax(mj))
    tmpc = port_mpc(mt)
    state = State(q=t64([0.0, 0.15]), v=t64([0.0, 0.0]))
    plans_j, plans_t, t = [], [], 0.0

    def observe_and_replan(t_obs, now):
        jmpc.record_state(t_obs, JState(q=jnp.asarray(state.q.numpy()),
                                        v=jnp.asarray(state.v.numpy())))
        tmpc.record_state(t_obs, state)
        jmpc.replan_at(now)
        tmpc.replan_at(now)
        plans_j.append(jmpc.plan)
        plans_t.append(tmpc.plan)

    observe_and_replan(0.0, 0.0)
    for _ in range(2):
        u = tmpc.control_now(t, state)
        state = step(mt, state, u)
        t += DT
        observe_and_replan(t, t + 0.5 * DT)
    return mt, plans_j, plans_t


# -- 1. control-plan indexing ------------------------------------------------


def test_control_plan_indexing():
    plan = ControlPlan(start_time=1.0, dt=0.1, u=torch.tensor([[1.0], [2.0], [3.0]]))
    assert float(control_at(plan, 0.5)[0]) == 1.0   # before start: clamp
    assert float(control_at(plan, 1.05)[0]) == 1.0
    assert float(control_at(plan, 1.15)[0]) == 2.0
    assert float(control_at(plan, 9.0)[0]) == 3.0   # past end: clamp
    assert [plan_index(plan, t) for t in (0.5, 1.05, 1.15, 9.0)] == [0, 0, 1, 2]


def test_control_at_gain_feedback_matches_jax():
    rng = np.random.default_rng(0)
    u, x_ref = rng.standard_normal((3, 2)), rng.standard_normal((4, 4))
    K = rng.standard_normal((3, 2, 4))
    x = rng.standard_normal(4)
    pt = ControlPlan(1.0, 0.1, t64(u), t64(x_ref), t64(K))
    pj = jbuf.ControlPlan(1.0, 0.1, jnp.asarray(u), jnp.asarray(x_ref), jnp.asarray(K))
    for t in (0.5, 1.15, 9.0):
        np.testing.assert_allclose(control_at(pt, t, t64(x)).numpy(),
                                   np.asarray(jbuf.control_at(pj, t, jnp.asarray(x))),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_array_equal(control_at(pt, t).numpy(), u[plan_index(pt, t)])


# -- 2. estimate_state_at on the plant's constrained step ----------------------


def test_estimate_state_at_matches_jax():
    """Three steps of the limited cartpole pushed into its pole limit under
    a plan with gains: the port's contact_step against the JAX package's."""
    mj = jb.cartpole(dt=DT).replace(q_lower=jnp.asarray([-0.6, -0.5]),
                                    q_upper=jnp.asarray([0.6, 0.5]))
    mt = to_port(mj)
    rng = np.random.default_rng(1)
    u = np.full((5, 1), 40.0)
    x_ref = 0.1 * rng.standard_normal((6, 4))
    K = rng.standard_normal((5, 1, 4))
    q0, v0 = np.array([0.3, 0.45]), np.array([1.0, 1.5])
    st = estimate_state_at(mt, ControlPlan(0.0, DT, t64(u), t64(x_ref), t64(K)),
                           State(t64(q0), t64(v0)), 0.01, 0.01 + 3 * DT)
    sj = jbuf.estimate_state_at(mj, jbuf.ControlPlan(0.0, DT, jnp.asarray(u),
                                                     jnp.asarray(x_ref), jnp.asarray(K)),
                                JState(jnp.asarray(q0), jnp.asarray(v0)), 0.01, 0.01 + 3 * DT)
    assert float(st.q[1]) == pytest.approx(0.5, abs=0.05)  # at the limit
    np.testing.assert_allclose(st.q.numpy(), np.asarray(sj.q), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=1e-10, atol=1e-10)


# -- 3. the port's MPC against the JAX MPC ----------------------------------


@pytest.mark.parametrize("field", ["u", "x_ref", "K"])
@pytest.mark.parametrize("replan", [0, 1, 2], ids=["cold", "warm1", "warm2"])
def test_mpc_plans_match_jax(loop, replan, field):
    _, plans_j, plans_t = loop
    pj, pt = plans_j[replan], plans_t[replan]
    assert pt.start_time == pytest.approx(pj.start_time, abs=1e-12) and pt.dt == pj.dt
    a, b = getattr(pt, field).numpy(), np.asarray(getattr(pj, field))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_mpc_warm_replans_shift_the_plan(loop):
    _, _, plans_t = loop
    starts = [p.start_time for p in plans_t]
    assert starts == pytest.approx([0.0, 2 * DT, 3 * DT])
    assert all(torch.isfinite(p.u).all() for p in plans_t)


# -- 4. AsyncMPC, Ticker and the entry point's refusals -----------------------


def test_async_mpc_publishes_and_serves():
    """The replanner thread publishes through the port's native buffer while
    the control thread serves, without calling replan_at itself."""
    mt = to_port(jb.cartpole(dt=DT))
    mpc = port_mpc(mt)
    state = State(q=t64([0.0, 0.15]), v=t64([0.0, 0.0]))
    clock = [0.0]
    amp = AsyncMPC(mpc, clock=lambda: clock[0])
    amp.record_state(0.0, state)
    lat = []
    with amp:
        deadline = time.time() + 60.0
        while mpc.plan is None and time.time() < deadline:
            time.sleep(0.01)
        assert mpc.plan is not None, "the replanner never published"
        for _ in range(200):
            t0 = time.perf_counter()
            u = amp.control_now(clock[0], state)
            lat.append(time.perf_counter() - t0)
            state = step(mt, state, u)
            clock[0] += DT
            amp.record_state(clock[0], state)
            if amp.num_published >= 3 and len(lat) >= 20:
                break
    assert amp.num_published >= 2
    assert len(amp.replan_durations) >= 2 and min(amp.replan_durations) > 0
    assert np.isfinite(state.flat().numpy()).all()
    assert float(np.median(lat)) < 0.02
    u_native = amp.control_now_native(clock[0])
    assert u_native.shape == (1,) and np.isfinite(u_native).all()


def test_ticker_runs_its_callbacks():
    seen = []
    ticker = Ticker(0.01)
    ticker.register(seen.append)
    assert ticker.run(3, t0=1.0) == pytest.approx(1.03)
    assert seen == pytest.approx([1.0, 1.01, 1.02])


def test_mpc_refusals(monkeypatch):
    mt = to_port(jb.cartpole(dt=DT))
    run, fin = port_costs(mt)
    # a planning model with limit rows needs the implicit LCP derivative
    with pytest.raises(NotImplementedError, match="M4"):
        MPC(mt, run, fin, device="cpu")
    # the model and the plan on different devices
    with pytest.raises(ValueError, match="is on cpu, the plan on meta"):
        MPC(mt, run, fin, planning_model=relax_limits(mt), device="meta")
    # on the card the costs must be data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(TypeError, match="QuadraticCost"):
        MPC(mt, lambda x, u, t: (x ** 2).sum(), fin, planning_model=relax_limits(mt))
    # device defaults to "cuda": without it, MPC raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MPC(mt, run, fin, planning_model=relax_limits(mt))
