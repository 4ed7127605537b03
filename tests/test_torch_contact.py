"""The port's constraint pieces against the JAX package, f64 unless said:
the boxed LCP (direct_boxed_solve, its lane form, classification and the
residual) and solve_frozen at a PCG depth below m (its implicit tangent)
on seeded SPD systems with m = 4 and 6 at rel 1e-10; on the
cartpole with the narrowed limits of tests/test_frozen_contact.py, driven
into them, the constraint assembly in both forms, contact_step,
solve_frozen with its implicit tangent (also in f32 at cg_iters=4),
frozen_contact_step, classify_points, step_with_classes_for_trace and the
full-LCP rollout_classes scan at rel 1e-10; and model_from_numpy with
limits. Each JAX reference is computed once per module under one jit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.ops import contact as jc
from nimblephysics_tpu.ops import dynamics as jd
from nimblephysics_tpu.ops import frozen_contact as jf
from nimblephysics_tpu.ops import lcp as jl
from nimblephysics_tpu.ops.collide import detect_contacts as j_detect

from nimblephysics_tpu_torch.models.model import State
from nimblephysics_tpu_torch.ops import contact as tc
from nimblephysics_tpu_torch.ops import dynamics as td
from nimblephysics_tpu_torch.ops import frozen_contact as tf
from nimblephysics_tpu_torch.ops import lcp as tl
from nimblephysics_tpu_torch.ops.collide import detect_contacts as t_detect
from nimblephysics_tpu_torch.ops.linalg_small import solve_spd

from torch_port_helpers import jax_leaves, jax_static, t64, to_port

RTOL = 1e-10
BIG = 1e20
N_SYS = 6          # seeded LCPs per size
B, T = 4, 8        # cartpole states and rollout steps
FROZEN_CG = 2      # PCG depth of the seeded frozen solves, below m


def close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


# ----------------------------------------------------------------- the LCP


def lcp_systems(m, seed):
    """N_SYS SPD systems A = G G^T / m + 0.1 I with rows of every bound type
    the direct solve takes: one-sided (limit) rows [0, BIG], boxed
    (Coulomb) rows [-f, f] and, for m = 6, a bilateral row [-BIG, BIG]; b
    with both signs, so some rows clamp and some separate."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N_SYS, m, m))
    A = np.einsum("nij,nkj->nik", G, G) / m + 0.1 * np.eye(m)
    b = 2.0 * rng.standard_normal((N_SYS, m))
    lo = np.zeros((N_SYS, m))
    hi = np.full((N_SYS, m), BIG)
    lo[:, 2], hi[:, 2] = -0.3, 0.3
    if m == 6:
        lo[:, 5], hi[:, 5] = -BIG, BIG
    findex = (-1,) * m if m == 4 else (-1, 0, 0, -1, 3, 3)
    fscale = np.zeros((N_SYS, m)) if m == 4 else np.tile([0, .5, .5, 0, .8, .8], (N_SYS, 1))
    return A, b, lo, hi, fscale, findex


def gov_of(findex):
    """gov_matrix of a friction index: gov[i, f] = 1 where row i is a
    friction row of the normal row f."""
    gov = np.zeros((len(findex),) * 2)
    for i, f in enumerate(findex):
        if f >= 0:
            gov[i, f] = 1.0
    return gov


@pytest.fixture(scope="module", params=[4, 6])
def lcp_case(request):
    """The seeded systems and the JAX references; for solve_frozen every row
    clamps (us from the classification), with seeded tangents (dA, db)."""
    m = request.param
    A, b, lo, hi, fscale, findex = lcp_systems(m, seed=m)
    rng = np.random.default_rng(10 + m)
    dA, db = rng.standard_normal((N_SYS, m, m)), rng.standard_normal((N_SYS, m))
    gov = jnp.asarray(gov_of(findex))

    def one(A, b, lo, hi, fs, dA, db):
        x = jl.direct_boxed_solve(A, b, lo, hi)
        xl = jl.direct_boxed_solve_lane(A, b, lo, hi)
        # classify a candidate with exact-bound and interior entries
        xc = jnp.where(jnp.arange(m) % 2 == 0, x, jnp.clip(x, lo, hi))
        cls = jl._classify(xc, lo, hi, fs, findex)
        frozen = jf.FrozenClasses(cmask=jnp.ones(m), us=cls[1] * cls[2])
        fz = jax.jvp(lambda A_, b_: jf.solve_frozen(A_, b_, frozen, gov, cg_iters=FROZEN_CG),
                     (A, b), (dA, db))
        return dict(x=x, xl=xl, cls=cls, frozen_us=frozen.us, fz=fz,
                    cls_lane=jl.classify_lane(xc, lo, hi, fs, findex), xc=xc,
                    res=jl.lcp_residual(A, x, b, lo, hi, fs, findex),
                    res_l=jl.lcp_residual(A, xl, b, lo, hi, fs, findex))

    ref = jax.jit(jax.vmap(one))(*map(jnp.asarray, (A, b, lo, hi, fscale, dA, db)))
    return dict(m=m, args=tuple(map(t64, (A, b, lo, hi))), fscale=t64(fscale),
                findex=findex, gov=t64(gov), tangents=(t64(dA), t64(db)),
                ref=jax.tree_util.tree_map(np.asarray, ref))


def test_direct_boxed_solve_matches_jax(lcp_case):
    A, b, lo, hi = lcp_case["args"]
    x = tl.direct_boxed_solve(A, b, lo, hi)
    close(x, lcp_case["ref"]["x"])
    # the fixture has clamping and separating rows
    assert bool((x > 1e-6).any()) and bool((x.abs() < 1e-12).any())


def test_direct_boxed_solve_lane_matches_jax(lcp_case):
    close(tl.direct_boxed_solve_lane(*lcp_case["args"]), lcp_case["ref"]["xl"])


def test_classify_matches_jax(lcp_case):
    _, _, lo, hi = lcp_case["args"]
    ref = lcp_case["ref"]
    xc = t64(ref["xc"])
    for fn, key in ((tl._classify, "cls"), (tl.classify_lane, "cls_lane")):
        cl, up, sgn = fn(xc, lo, hi, lcp_case["fscale"], lcp_case["findex"])
        np.testing.assert_array_equal(cl.numpy(), ref[key][0])
        np.testing.assert_array_equal(up.numpy(), ref[key][1])
        close(sgn, ref[key][2])
    assert ref["cls"][0].any() and not ref["cls"][0].all()


def test_lcp_residual_matches_jax(lcp_case):
    A, b, lo, hi = lcp_case["args"]
    ref = lcp_case["ref"]
    for key, res_key in (("x", "res"), ("xl", "res_l")):
        r = tl.lcp_residual(A, t64(ref[key]), b, lo, hi, lcp_case["fscale"], lcp_case["findex"])
        close(r, ref[res_key])


def test_solve_frozen_short_pcg_takes_the_implicit_tangent(lcp_case, monkeypatch):
    """With every row clamping, FROZEN_CG PCG iterations stop short of the
    solution (m > FROZEN_CG): the value and the implicit tangent of
    lax.custom_linear_solve match the JAX package's at rel 1e-10, and the
    derivative of the truncated iteration, which forward mode through the
    iterations would give, is rejected by that comparison."""
    from torch_port_helpers import iterate_through_pcg

    A, b, _, _ = lcp_case["args"]
    m, ref = lcp_case["m"], lcp_case["ref"]
    cl = tf.FrozenClasses(torch.ones(N_SYS, m, dtype=torch.float64), t64(ref["frozen_us"]))

    def solve(A_, b_):
        return tf.solve_frozen(A_, b_, cl, lcp_case["gov"], cg_iters=FROZEN_CG)

    x, dx = torch.func.jvp(solve, (A, b), lcp_case["tangents"])
    want_x, want_dx = ref["fz"]
    close(x, want_x)
    close(dx, want_dx)
    iterate_through_pcg(monkeypatch)
    _, dx_iter = torch.func.jvp(solve, (A, b), lcp_case["tangents"])
    gap = float((dx_iter - t64(want_dx)).abs().max()) / float(np.abs(want_dx).max())
    assert gap > 1e-3, gap


def test_boxed_lcp_direct_has_no_derivative_yet():
    """The direct solve now carries the implicit derivative (its JAX parity
    is tests/test_torch_lcp_grad.py): backward gives the transpose of its
    forward-mode Jacobian, zero on the rows that do not clamp; "jacobi"
    (ported with the staged cascade) gives jacobi_solve's answer."""
    A, b, lo, hi, _, _ = lcp_systems(4, seed=1)
    args = [t64(a) for a in (A, b, lo, hi)]
    args[1].requires_grad_(True)
    zeros = torch.zeros(N_SYS, 4, dtype=torch.float64)
    x = tl.boxed_lcp(args[0], args[1], args[2], args[3], zeros, zeros, (-1,) * 4, 3, "direct")
    close(x.detach(), tl.direct_boxed_solve(args[0], args[1].detach(), args[2], args[3]))
    x.sum().backward()
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda b_, A_, lo_, hi_: tl.boxed_lcp(A_, b_, lo_, hi_, torch.zeros_like(b_),
                                              torch.zeros_like(b_), (-1,) * 4, 3, "direct")))(
        args[1].detach(), args[0], args[2], args[3])
    close(args[1].grad, jac.sum(-2), 1e-13)
    clamping = tl._classify(x.detach(), args[2], args[3], zeros, (-1,) * 4)[0]
    assert bool(clamping.any()) and not bool(clamping.all())
    assert bool((args[1].grad[~clamping] == 0.0).all())
    plain = [a.detach() for a in args]
    assert torch.equal(tl.boxed_lcp(*plain, zeros, zeros, (-1,) * 4, 60, "jacobi"),
                       tl.jacobi_solve(*plain, zeros, zeros, (-1,) * 4, 60))


# ---------------------------------------------- the narrowed-limit cartpole


def narrowed_jax():
    return jb.cartpole(dt=0.02).replace(q_lower=jnp.asarray([-0.6, -0.5]),
                                        q_upper=jnp.asarray([0.6, 0.5]))


def driven_states(mt):
    """B states of the narrowed cartpole driven into its limits: from
    (q, v) near the middle the cart is pushed at 6 N for 40-55 steps
    (tests/test_frozen_contact.py drives it 60), on the port's own step;
    then the actions of the rollouts."""
    rng = np.random.default_rng(11)
    q = torch.tensor(np.stack([np.zeros(B), rng.uniform(0.1, 0.4, B)], 1))
    v = torch.zeros(B, 2, dtype=torch.float64)
    steps = (40, 45, 50, 55)
    s = State(q, v)
    qs, vs = [None] * B, [None] * B
    for t in range(max(steps)):
        s = tc.contact_step(mt, s, torch.tensor([6.0, 0.0], dtype=torch.float64).expand(B, 2))
        for i, n in enumerate(steps):
            if t + 1 == n:
                qs[i], vs[i] = s.q[i], s.v[i]
    acts = np.concatenate([np.full((B, T // 2, 1), 6.0), rng.uniform(-8, 8, (B, T - T // 2, 1))], 1)
    return torch.stack(qs).numpy(), torch.stack(vs).numpy(), acts


@pytest.fixture(scope="module")
def cart():
    mj = narrowed_jax()
    mt = to_port(mj)
    q, v, acts = driven_states(mt)
    rng = np.random.default_rng(12)
    tau = np.concatenate([rng.uniform(-8, 8, (B, 1)), np.zeros((B, 1))], 1)
    dA = rng.standard_normal((B, 4, 4))
    db = rng.standard_normal((B, 4))
    gov = jnp.asarray(jf.gov_matrix(mj))
    findex = jc.lcp_findex(mj)

    def per_state(q, v, tau, acts):
        kin = jd.forward_kinematics(mj, q)
        v_star = v + mj.dt * jd.aba(mj, q, v, tau, kin=kin)
        contacts = j_detect(mj, kin.T_wb)
        sys_full = jc.build_constraint_system(mj, q, v_star, kin, contacts)
        sys_plan = jc.build_constraint_system(mj, q, v_star, kin, contacts, planner=True)
        s2, info = jc.contact_step(mj, JState(q, v), tau, return_info=True)
        cl = jf.classes_from_info(info)
        fz = jf.frozen_contact_step(mj, JState(q, v), tau, cl)
        x = jnp.concatenate([q, v])
        swc = jf.step_with_classes_for_trace(mj)(x, acts[0])
        final, traj, cl_seq, imps = jf.rollout_classes(mj, JState(q, v), acts)
        return dict(sys_full=sys_full, sys_plan=sys_plan, q2=s2.q, v2=s2.v,
                    imp=info.impulses, J=info.J, v_star=info.v_star, clamping=info.clamping,
                    upper=info.upper, upper_sign=info.upper_sign, residual=info.residual,
                    cmask=cl.cmask, us=cl.us, fz_q=fz.q, fz_v=fz.v, swc=swc,
                    traj_q=traj.q, traj_v=traj.v, seq_cm=cl_seq.cmask, seq_us=cl_seq.us,
                    seq_imp=imps, final_q=final.q)

    def frozen_solves(A, b, cm, us, dA, db):
        out = {}
        for name, dt, cg in (("f64", jnp.float64, None), ("f32", jnp.float32, 4)):
            c = lambda a: a.astype(dt)  # noqa: E731
            fn = lambda A_, b_: jf.solve_frozen(A_, b_, jf.FrozenClasses(c(cm), c(us)),  # noqa: E731
                                               c(gov), cg_iters=cg)
            out[name] = jax.jvp(fn, (c(A), c(b)), (c(dA), c(db)))
        return out

    def reference(q, v, tau, acts, dA, db):
        per = jax.vmap(per_state)(q, v, tau, acts)
        A = per["sys_plan"][1]
        b = per["sys_plan"][2]
        per["solve"] = jax.vmap(frozen_solves)(A, b, per["cmask"], per["us"], dA, db)
        x_pts = jnp.concatenate([per["traj_q"], per["traj_v"]], -1)
        taus = jax.vmap(jax.vmap(mj.action_to_tau))(acts)
        per["points"] = jf.classify_points(mj, x_pts, taus)
        return per

    ref = jax.jit(reference)(*map(jnp.asarray, (q, v, tau, acts, dA, db)))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert ref["clamping"].any() and not ref["clamping"].all(), "states must touch the limits"
    assert ref["seq_cm"].any()
    return dict(mj=mj, mt=mt, q=t64(q), v=t64(v), tau=t64(tau), acts=t64(acts), dA=t64(dA),
                db=t64(db), findex=findex, ref=ref)


def port_kin(cart):
    mt, q, v, tau = cart["mt"], cart["q"], cart["v"], cart["tau"]
    kin = td.forward_kinematics(mt, q)
    v_star = v + mt.dt * td.aba(mt, q, v, tau, kin=kin)
    return mt, q, v_star, kin, t_detect(mt, kin.T_wb)


@pytest.mark.parametrize("planner", [False, True], ids=["full", "planner"])
def test_build_constraint_system_matches_jax(cart, planner):
    mt, q, v_star, kin, contacts = port_kin(cart)
    got = tc.build_constraint_system(mt, q, v_star, kin, contacts, planner=planner)
    want = cart["ref"]["sys_plan" if planner else "sys_full"]
    for g, w in zip(got, want):
        close(g, w)


def test_contact_step_matches_jax(cart):
    ref = cart["ref"]
    s2, info = tc.contact_step(cart["mt"], State(cart["q"], cart["v"]), cart["tau"],
                               return_info=True)
    close(s2.q, ref["q2"])
    close(s2.v, ref["v2"])
    for key in ("impulses", "J", "v_star", "upper_sign", "residual"):
        close(getattr(info, key), ref["imp" if key == "impulses" else key])
    np.testing.assert_array_equal(info.clamping.numpy(), ref["clamping"])
    np.testing.assert_array_equal(info.upper.numpy(), ref["upper"])
    assert tc.lcp_findex(cart["mt"]) == cart["findex"]
    assert tc.lcp_dim(cart["mt"]) == 4


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_solve_frozen_and_implicit_tangent_match_jax(cart, dtype):
    """Value and tangent of solve_frozen: the JAX package's implicit tangent
    of lax.custom_linear_solve, in f64 at the default PCG depth and in f32
    at cg_iters=4 (rel 2e-4, the f32 tolerance of the kernel checks; the
    two sides sum in another order)."""
    ref = cart["ref"]
    tdt = torch.float64 if dtype == "f64" else torch.float32
    cg = None if dtype == "f64" else 4
    rtol = RTOL if dtype == "f64" else 2e-4
    mt = cart["mt"]
    gov = torch.as_tensor(tf.gov_matrix(mt), dtype=tdt)
    A, b = t64(ref["sys_plan"][1]).to(tdt), t64(ref["sys_plan"][2]).to(tdt)
    cl = tf.FrozenClasses(t64(ref["cmask"]).to(tdt), t64(ref["us"]).to(tdt))
    x, dx = torch.func.jvp(lambda A_, b_: tf.solve_frozen(A_, b_, cl, gov, cg_iters=cg),
                           (A, b), (cart["dA"].to(tdt), cart["db"].to(tdt)))
    want_x, want_dx = ref["solve"][dtype]
    close(x.double(), want_x, rtol)
    close(dx.double(), want_dx, rtol)


def test_frozen_contact_step_matches_jax(cart):
    ref = cart["ref"]
    cl = tf.FrozenClasses(t64(ref["cmask"]), t64(ref["us"]))
    s2 = tf.frozen_contact_step(cart["mt"], State(cart["q"], cart["v"]), cart["tau"], cl)
    close(s2.q, ref["fz_q"])
    close(s2.v, ref["fz_v"])


def test_step_with_classes_for_trace_matches_jax(cart):
    ref = cart["ref"]
    x = torch.cat([cart["q"], cart["v"]], -1)
    x2, cm, us = tf.step_with_classes_for_trace(cart["mt"])(x, cart["acts"][:, 0])
    close(x2, ref["swc"][0])
    np.testing.assert_array_equal(cm.numpy(), ref["swc"][1])
    close(us, ref["swc"][2])


def test_rollout_classes_scan_matches_jax(cart):
    ref = cart["ref"]
    final, traj, cl, imps = tf.rollout_classes(cart["mt"], State(cart["q"], cart["v"]),
                                               cart["acts"])
    close(traj.q, ref["traj_q"])
    close(traj.v, ref["traj_v"])
    close(final.q, ref["final_q"])
    np.testing.assert_array_equal(cl.cmask.numpy(), ref["seq_cm"])
    close(cl.us, ref["seq_us"])
    close(imps, ref["seq_imp"])


def test_classify_points_matches_jax(cart):
    ref = cart["ref"]
    x_pts = torch.cat([t64(ref["traj_q"]), t64(ref["traj_v"])], -1)
    cl, imps = tf.classify_points(cart["mt"], x_pts, cart["mt"].action_to_tau(cart["acts"]))
    want_cl, want_imp = ref["points"]
    np.testing.assert_array_equal(cl.cmask.numpy(), want_cl.cmask)
    close(cl.us, want_cl.us)
    close(imps, want_imp)


def test_solve_spd_matches_jax():
    from nimblephysics_tpu.ops.linalg_small import solve_spd as j_solve_spd

    rng = np.random.default_rng(3)
    G = rng.standard_normal((3, 5, 5))
    A = np.einsum("nij,nkj->nik", G, G) + 0.5 * np.eye(5)
    for b in (rng.standard_normal((3, 5)), rng.standard_normal((3, 5, 2))):
        close(solve_spd(t64(A), t64(b)), j_solve_spd(jnp.asarray(A), jnp.asarray(b)))


def test_model_from_numpy_carries_limits_and_rows():
    """The limits and the (empty) constraint topology cross over, and the
    port counts the same LCP rows as the JAX package."""
    from nimblephysics_tpu_torch.models.convert import model_from_numpy

    mj = narrowed_jax().replace(coulomb_friction=jnp.asarray([0.0, 0.3]))
    static = dict(jax_static(mj), shapes=mj.shapes, servo_dofs=mj.servo_dofs, mimic=mj.mimic,
                  loops=mj.loops)
    mt = model_from_numpy(static, jax_leaves(mj), device="cpu")
    close(mt.q_lower, mj.q_lower)
    close(mt.q_upper, mj.q_upper)
    close(mt.coulomb_friction, mj.coulomb_friction)
    assert tc.lcp_dim(mt) == jc.lcp_dim(mj) == 5
    assert tc.lcp_findex(mt) == jc.lcp_findex(mj)
    assert tc.limited_dofs(mt) == jc.limited_dofs(mj)
    assert tc.coulomb_dofs(mt) == jc.coulomb_dofs(mj)
    assert tf.fused_class_rollout_ok(mt) == jf.fused_class_rollout_ok(mj)
    with pytest.raises(NotImplementedError, match="M4"):
        model_from_numpy(dict(static, servo_dofs=(0,)), jax_leaves(mj), device="cpu")
