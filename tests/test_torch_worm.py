"""The jump worm's contact path against the JAX package on the CPU, f64:

  * builders.jump_worm and model_from_numpy (leaves and shapes equal, the
    same slots, LCP rows and findex);
  * world_jacobian, detect_contacts and build_constraint_system in the
    planner and the full form at worm states in and out of floor contact,
    rel 1e-12;
  * pgs_solve / boxed_lcp("gs") on the worm's frictional LCPs, rel 1e-10;
  * contact_step and classify_points at those states (impulses rel 1e-9,
    classes identical, lcp_residual rel 1e-9);
  * solve_frozen's reverse mode against jax.vjp of the JAX frozen solve
    (its lax.custom_linear_solve transpose), rel 1e-10, at the PCG depth
    the replan uses (12) and at 2, below the clamping rows;
  * solve_contact_mpc_batch(class_refresh="pointwise") as a whole at B=2,
    T=10 (one iteration, bench.py's worm costs and budget otherwise; the
    JAX side with linearize="xla" and rollout="xla", its f64-exact lanes):
    u, x, cost and the returned classes at rel 1e-9; the port's replan with
    linearize="chain" against the same JAX replan (not the JAX chain replan,
    which takes ~90 s here: its "xla" linearize at this fixture is the
    function K5 and the chain compute).

States: numpy default_rng(SEED) around the worm resting on the floor (root
y = -0.528, 3 mm into the floor), moving down and sliding (x velocity up to
1.5 m/s), so that normal, friction (stuck and sliding) and joint-limit rows
all clamp somewhere. The JAX references are computed once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.ops import collide as jcol
from nimblephysics_tpu.ops import contact as jc
from nimblephysics_tpu.ops import dynamics as jd
from nimblephysics_tpu.ops import frozen_contact as jf
from nimblephysics_tpu.ops import lcp as jl
from nimblephysics_tpu.trajectory.ilqr import ILQRConfig as JConfig
from nimblephysics_tpu.trajectory.ilqr import solve_contact_mpc_batch as j_contact_mpc

from nimblephysics_tpu_torch.models import builders as tb
from nimblephysics_tpu_torch.models.model import LEAF_NAMES, State
from nimblephysics_tpu_torch.ops import collide as tcol
from nimblephysics_tpu_torch.ops import contact as tc
from nimblephysics_tpu_torch.ops import dynamics as td
from nimblephysics_tpu_torch.ops import frozen_contact as tf
from nimblephysics_tpu_torch.ops import lcp as tl
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost
from nimblephysics_tpu_torch.trajectory.ilqr import ILQRConfig, solve_contact_mpc_batch

from torch_port_helpers import jax_leaves, t64, to_port

SEED = 11
N = 6                 # worm states
B, T = 2, 10          # the replan's worlds and horizon
CG = 12               # bench.py's planner PCG depth


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def worm_states(n=N, seed=SEED):
    """q around the resting worm (root 3 mm into the floor, links at or
    near their lower limits), moving down and sliding; the first state is
    above the floor (no slot active)."""
    rng = np.random.default_rng(seed)
    q = 0.01 * rng.standard_normal((n, 4))
    q[:, 1] += -0.528
    q[:, 2:] = 0.5 * np.abs(q[:, 2:]) - 0.004
    v = 0.05 * rng.standard_normal((n, 4))
    v[:, 1] = -0.4
    v[:, 0] = rng.uniform(-1.5, 1.5, n)
    q[0, 1] = -0.5
    u = 20.0 * rng.standard_normal((n, 2))
    return q, v, u


@pytest.fixture(scope="module")
def worm():
    mj = jb.jump_worm(dt=0.001)
    mt = to_port(mj)
    q, v, u = worm_states()
    tau = np.zeros((N, 4))
    tau[:, 2:] = u

    def j_parts(qi, vi, taui):
        kin = jd.forward_kinematics(mj, qi)
        qdd = jd.aba(mj, qi, vi, taui, kin=kin)
        v_star = vi + mj.dt * qdd
        cont = jcol.detect_contacts(mj, kin.T_wb)
        full = jc.build_constraint_system(mj, qi, v_star, kin, cont)
        plan = jc.build_constraint_system(mj, qi, v_star, kin, cont, planner=True)
        st, info = jc.contact_step(mj, JState(qi, vi), taui, return_info=True)
        return (jd.world_jacobian(mj, kin), cont.point, cont.normal, cont.depth, v_star, full,
                plan, st.q, st.v, info.impulses, info.clamping, info.upper, info.upper_sign,
                info.residual)

    ref = jax.jit(jax.vmap(j_parts))(jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau))
    names = ("Jw", "point", "normal", "depth", "v_star", "full", "plan", "q1", "v1", "imp",
             "clamp", "upper", "sign", "resid")
    return dict(mj=mj, mt=mt, q=q, v=v, u=u, tau=tau, ref=dict(zip(names, ref)))


def test_builder_and_conversion_match_jax(worm):
    mj, mt = worm["mj"], worm["mt"]
    built = tb.jump_worm(dt=0.001, dtype=torch.float64, device="cpu")
    lj = jax_leaves(mj)
    for model in (built, mt):
        for k in LEAF_NAMES:
            np.testing.assert_array_equal(model.leaves()[k].numpy(), lj[k], err_msg=k)
        assert model.joint_types == mj.joint_types and model.actuated == mj.actuated
        assert len(model.shapes) == len(mj.shapes)
        for st, sj in zip(model.shapes, mj.shapes):
            assert (st.kind, st.body_index) == (sj.kind, sj.body_index)
            for f in ("params", "friction", "restitution"):
                np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
            np.testing.assert_array_equal(st.offset.R.numpy(), np.asarray(sj.offset.R))
        assert tcol.enumerate_pairs(model) == jcol.enumerate_pairs(mj)
        assert tc.lcp_dim(model) == jc.lcp_dim(mj) == 28
        assert tc.lcp_findex(model) == jc.lcp_findex(mj)
        assert tuple(tc.lcp_findex(model)[:6]) == (-1, 0, 0, -1, 3, 3)
        assert tuple(tc.lcp_findex(model)[21:]) == (-1, 21, 21, -1, -1, -1, -1)
        assert tf.fused_class_rollout_ok(model) == jf.fused_class_rollout_ok(mj) is False


def test_kinematics_and_contacts_match_jax(worm):
    mt, ref = worm["mt"], worm["ref"]
    kin = td.forward_kinematics(mt, t64(worm["q"]))
    close(td.world_jacobian(mt, kin), ref["Jw"], 1e-12)
    cont = tcol.detect_contacts(mt, kin.T_wb)
    for name in ("point", "normal", "depth"):
        close(getattr(cont, name), ref[name], 1e-12)
    assert not bool(cont.active[0].any()) and bool(cont.active[1:].any())
    # point_jacobian is the world Jacobian's point rows
    pj = td.point_jacobian(mt, kin, 0, cont.point[:, 0])
    Jw = td.world_jacobian(mt, kin)[:, 0]
    close(pj, Jw[:, 3:] + torch.linalg.cross(Jw[:, :3], cont.point[:, 0, :, None]
                                              .expand(-1, -1, 4), dim=1), 1e-12)


@pytest.mark.parametrize("planner", (False, True))
def test_build_constraint_system_matches_jax(worm, planner):
    mt, ref = worm["mt"], worm["ref"]
    q = t64(worm["q"])
    kin = td.forward_kinematics(mt, q)
    cont = tcol.detect_contacts(mt, kin.T_wb)
    got = tc.build_constraint_system(mt, q, t64(ref["v_star"]), kin, cont, planner=planner)
    for a, b in zip(got, ref["plan" if planner else "full"]):
        close(a, b, 1e-12)


def test_pgs_and_boxed_lcp_gs_match_jax(worm):
    """The worm's full LCPs (friction-coupled), 60 sweeps from zero."""
    J, A, b, lo, hi, fs, _ = (np.asarray(a) for a in worm["ref"]["full"])
    findex = jc.lcp_findex(worm["mj"])
    x0 = np.zeros_like(b)
    want = jax.vmap(lambda *a: jl.pgs_solve(*a, findex, 60))(
        *(jnp.asarray(t) for t in (A, b, lo, hi, fs, x0)))
    got = tl.pgs_solve(*(t64(t) for t in (A, b, lo, hi, fs, x0)), findex, 60)
    close(got, want, 1e-10)
    got_b = tl.boxed_lcp(*(t64(t) for t in (A, b, lo, hi, fs, x0)), findex, 60, "gs")
    close(got_b, want, 1e-10)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3


def test_contact_step_and_classify_points_match_jax(worm):
    mt, ref = worm["mt"], worm["ref"]
    x = t64(np.concatenate([worm["q"], worm["v"]], axis=1))
    st, info = tc.contact_step(mt, State.from_flat(x), t64(worm["tau"]), return_info=True)
    close(st.q, ref["q1"], 1e-12)
    close(st.v, ref["v1"], 1e-9)
    close(info.impulses, ref["imp"], 1e-9)
    np.testing.assert_array_equal(info.clamping.numpy(), np.asarray(ref["clamp"]))
    np.testing.assert_array_equal(info.upper.numpy(), np.asarray(ref["upper"]))
    close(info.upper_sign, ref["sign"], 1e-12)
    close(info.residual, ref["resid"], 1e-9)
    cl, imp = tf.classify_points(mt, x, t64(worm["tau"]))
    close(imp, ref["imp"], 1e-9)
    np.testing.assert_array_equal(cl.cmask.numpy(), np.asarray(ref["clamp"]).astype(float))
    close(cl.us, np.asarray(ref["upper"]) * np.asarray(ref["sign"]), 1e-12)
    # every row kind clamps somewhere: normals, friction rows, limit rows
    # (the first state is above the floor: only limit rows there)
    clamp = np.asarray(ref["clamp"])
    assert clamp[:, 0:24:3].any() and clamp[:, 1:24:3].any() and clamp[:, 24:].any()
    assert np.asarray(ref["upper"]).any()
    assert not clamp[0, :24].any()


@pytest.mark.parametrize("cg", (CG, 2))
def test_solve_frozen_backward_matches_jax_vjp(worm, cg):
    """Reverse mode through the frozen solve: the same truncated PCG on the
    cotangent plus the closure cotangent, as jax.vjp transposes
    lax.custom_linear_solve; at cg = 2 the PCG stops short of the clamping
    rows, so only that rule (not the iteration's derivative) agrees."""
    _, A, b, *_ = (np.asarray(a) for a in worm["ref"]["plan"])
    clamp = np.asarray(worm["ref"]["clamp"]).astype(float)
    us = np.asarray(worm["ref"]["upper"]) * np.asarray(worm["ref"]["sign"])
    gov = jf.gov_matrix(worm["mj"])
    ct = np.random.default_rng(SEED + 1).standard_normal(b.shape)

    def j_solve(Ai, bi, cm, u_):
        return jf.solve_frozen(Ai, bi, jf.FrozenClasses(cm, u_), jnp.asarray(gov), cg_iters=cg)

    x_j, pull = jax.vjp(lambda Aa, bb: jax.vmap(j_solve)(Aa, bb, jnp.asarray(clamp),
                                                         jnp.asarray(us)),
                        jnp.asarray(A), jnp.asarray(b))
    gA_j, gb_j = pull(jnp.asarray(ct))
    At, bt = t64(A).requires_grad_(True), t64(b).requires_grad_(True)
    x_t = tf.solve_frozen(At, bt, tf.FrozenClasses(t64(clamp), t64(us)), t64(gov), cg_iters=cg)
    close(x_t, x_j, 1e-10)
    gA_t, gb_t = torch.autograd.grad(x_t, (At, bt), t64(ct))
    close(gA_t, gA_j, 1e-10)
    close(gb_t, gb_j, 1e-10)
    if cg == 2:
        from torch_port_helpers import iterate_through_pcg

        mp = pytest.MonkeyPatch()
        try:
            iterate_through_pcg(mp)
            At2 = t64(A).requires_grad_(True)
            x2 = tf.solve_frozen(At2, t64(b), tf.FrozenClasses(t64(clamp), t64(us)), t64(gov),
                                 cg_iters=cg)
            (g_iter,) = torch.autograd.grad(x2, (At2,), t64(ct))
        finally:
            mp.undo()
        gap = float((g_iter - t64(np.asarray(gA_j))).abs().max()) / float(np.abs(gA_j).max())
        assert gap > 1e-3, gap


# ---------------------------------------------- the pointwise contact replan


def worm_x0():
    """bench.py's worm start (q1 = -0.5, 0.02 N(0, 1) on q, v = 0), lowered
    by 4.5 cm so that the box starts in floor contact in both worlds."""
    q = np.zeros((B, 4))
    q[:, 1] = -0.5
    q = q + 0.02 * np.random.default_rng(1).standard_normal((B, 4))
    q[:, 1] -= 0.045
    return np.concatenate([q, np.zeros_like(q)], axis=1)


@pytest.fixture(scope="module")
def mpc(worm):
    mj, mt = worm["mj"], worm["mt"]
    x0 = worm_x0()

    def running(x, u, t):
        return 1e-5 * jnp.sum(u ** 2) + 2.0 * (x[1] + 0.4) ** 2

    def final(x):
        return 20.0 * (x[1] + 0.4) ** 2

    cfg = JConfig(iters=1, alphas=(1.0, 0.6, 0.3, 0.1), unroll=1, planner_cg_iters=CG,
                  linearize="xla", rollout="xla")
    sol_j, cl_j = jax.jit(lambda a, b: j_contact_mpc(
        mj, a, b, running, final, cfg, outer_iters=1, class_refresh="pointwise"))(
            jnp.asarray(x0), jnp.zeros((B, T, 2)))
    goal = torch.zeros(8, dtype=torch.float64)
    goal[1] = -0.4
    rc = QuadraticCost(mt, wq=t64([0.0, 2.0, 0.0, 0.0]), wu=1e-5, x_goal=goal)
    fc = QuadraticFinalCost(mt, wx=t64([0.0, 20.0] + [0.0] * 6), x_goal=goal)
    args = (mt, t64(x0), torch.zeros(B, T, 2, dtype=torch.float64), rc, fc,
            ILQRConfig(iters=1, alphas=(1.0, 0.6, 0.3, 0.1), planner_cg_iters=CG))
    sol_t, cl_t = solve_contact_mpc_batch(*args, outer_iters=1, class_refresh="pointwise")
    return dict(sol_j=sol_j, cl_j=cl_j, sol_t=sol_t, cl_t=cl_t, args=args)


@pytest.mark.parametrize("field", ("u", "x", "cost", "cost_history"))
def test_pointwise_replan_matches_jax(mpc, field):
    close(getattr(mpc["sol_t"], field), getattr(mpc["sol_j"], field), 1e-9)


@pytest.fixture(scope="module")
def mpc_chain(mpc):
    model, x0, u0, rc, fc, cfg = mpc["args"]
    sol, _ = solve_contact_mpc_batch(model, x0, u0, rc, fc,
                                     dataclasses.replace(cfg, linearize="chain"),
                                     outer_iters=1, class_refresh="pointwise")
    return sol


@pytest.mark.parametrize("field", ("u", "x", "cost", "cost_history"))
def test_pointwise_replan_chain_matches_jax(mpc, mpc_chain, field):
    """linearize="chain" against the JAX replan of the mpc fixture, whose
    linearize is "xla" (jacfwd of the frozen step), not "chain"."""
    close(getattr(mpc_chain, field), getattr(mpc["sol_j"], field), 1e-9)


def test_pointwise_replan_classes_match_jax(mpc):
    np.testing.assert_array_equal(mpc["cl_t"].cmask.numpy(), np.asarray(mpc["cl_j"].cmask))
    close(mpc["cl_t"].us, mpc["cl_j"].us, 1e-12)
    assert mpc["cl_t"].cmask[:, :, :24].sum() > 0      # the box reached the floor


def test_pointwise_replan_warm_classes_skip_the_refresh(mpc, monkeypatch):
    """With classes given, the first inner solve takes them as they are
    (no refresh rollout, no classification before it); the returned classes
    come from one classify_points on the solution."""
    calls = []
    real = tf.classify_points
    monkeypatch.setattr(tf, "classify_points",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sol, cl = solve_contact_mpc_batch(*mpc["args"], outer_iters=1, class_refresh="pointwise",
                                      classes=mpc["cl_t"])
    assert len(calls) == 1
    cold = []
    monkeypatch.setattr(tf, "classify_points", lambda *a, **k: cold.append(1) or real(*a, **k))
    solve_contact_mpc_batch(*mpc["args"], outer_iters=1, class_refresh="pointwise",
                            refresh_fixed_point=2)
    assert len(cold) == 3
    assert torch.isfinite(sol.cost).all() and cl.cmask.shape == (B, T, 28)
