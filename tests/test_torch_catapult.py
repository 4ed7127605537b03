"""The catapult in the port against the JAX package, f64 on the CPU:

  * ``builders.catapult`` against the JAX builder's model carried over by
    ``model_from_numpy``, leaf by leaf, shape by shape, with its 129 LCP
    rows (41 contact slots: 25 box/box, 8 and 8 box/floor; 3 limited
    tails);
  * ``_box_box`` against the JAX function at 64 seeded poses, the
    crossing bars of tests/test_contact.py and a box resting on a bigger
    one: points (but those of edge pairs with parallel axes, which are
    never active), normals and depths at rel 1e-12, identical active
    patterns, and the depths' jacrev against jax.jacrev;
  * a B = 2, T = 10 rollout with the projectile on the arm (box/box
    contact), and the gradient of examples/catapult_trajopt.py's loss with
    respect to the controls, against one jitted JAX value_and_grad (rel
    1e-9 and 1e-8);
  * ``staged_solve``, ``jacobi_solve`` and ``boxed_lcp(method=...)``
    against the JAX package on tests/test_lcp_robustness.py's hard LCP
    and the worm's m = 28 goldens (JAX's m = 129 cascade compiles too
    slowly for this suite);
  * ``contact_step(accuracy="staged")`` on the catapult: its residual at
    most the standard step's;
  * ``World`` and ``timestep`` against the JAX ``World`` (recording,
    ``state_jacobian``, the batched ``timestep`` against its steps) at rel
    1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.ops import collide as jcol
from nimblephysics_tpu.ops import contact as jc
from nimblephysics_tpu.ops import lcp as jl
from nimblephysics_tpu.ops.lie import Transform as JT
from nimblephysics_tpu.simulation.step import rollout as j_rollout
from nimblephysics_tpu.simulation.step import step as j_step
from nimblephysics_tpu.simulation.world import World as JWorld

from nimblephysics_tpu_torch.models import builders as tb
from nimblephysics_tpu_torch.models.model import State
from nimblephysics_tpu_torch.neural import step_jacobians
from nimblephysics_tpu_torch.ops import collide as tcol
from nimblephysics_tpu_torch.ops import contact as tc
from nimblephysics_tpu_torch.ops import lcp as tl
from nimblephysics_tpu_torch.ops.lie import Transform as TT
from nimblephysics_tpu_torch.simulation import World, timestep
from nimblephysics_tpu_torch.simulation.step import rollout as t_rollout

from torch_port_helpers import t64, to_port

TARGET = (2.2, 2.2)
# the example's start: tails at 45/0/45 deg, the projectile just above the
# arm's tip
Q0 = (-0.104, -0.02, np.pi / 4, 0.0, np.pi / 4)


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def models():
    jm = jb.catapult()
    return jm, to_port(jm)


def on_arm(B=2):
    """B states with the projectile resting on the arm (a vertex and an
    edge slot of the box pair penetrate by ~1e-4 to 1e-3), x shifted
    between the worlds, at rest."""
    q = np.tile(np.asarray(Q0), (B, 1))
    q[:, 0] += np.linspace(0.0, 0.004, B)
    q[:, 1] = np.linspace(-0.0216, -0.0222, B)
    return q, np.zeros_like(q)


# ------------------------------------------------------------------ builder


def test_catapult_builder_matches_jax(models):
    jm, cm = models
    pm = tb.catapult(dtype=torch.float64, device="cpu")
    for name, v in pm.leaves().items():
        assert torch.equal(v, cm.leaves()[name]), name
    assert (pm.joint_types, pm.parents, pm.actuated) == (cm.joint_types, cm.parents,
                                                         cm.actuated)
    for a, b in zip(pm.shapes, cm.shapes, strict=True):
        assert (a.kind, a.body_index) == (b.kind, b.body_index)
        for f in ("params", "friction", "restitution"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.offset.R, b.offset.R) and torch.equal(a.offset.p, b.offset.p)
    assert tcol.enumerate_pairs(pm) == jcol.enumerate_pairs(jm) == [(0, 1, 25), (0, 2, 8),
                                                                    (1, 2, 8)]
    assert tc.lcp_dim(pm) == jc.lcp_dim(jm) == 129
    assert tc.lcp_findex(pm) == jc.lcp_findex(jm)


# ---------------------------------------------------------------- box / box


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def _box_poses():
    """(name, pa, pb, Ra, pa_, Rb, pb_): 64 seeded poses of two boxes a few
    centimetres apart, the crossing bars of tests/test_contact.py (no
    vertex inside either box) and a cube resting on a big box at three
    depths."""
    rng = np.random.default_rng(3)
    n = 64
    cases = [("seeded", np.array([0.3, 0.2, 0.1, 0.0]), np.array([0.25, 0.15, 0.35, 0.0]),
              _rotations(rng, n), rng.uniform(-0.15, 0.15, (n, 3)), _rotations(rng, n),
              rng.uniform(-0.15, 0.15, (n, 3)))]
    eye2 = np.tile(np.eye(3), (2, 1, 1))
    cases.append(("crossing bars", np.array([0.2, 0.2, 4.0, 0.0]),
                  np.array([4.0, 0.2, 0.2, 0.0]), eye2,
                  np.array([[0.0, 0.17, 0.0], [0.01, 0.15, -0.02]]), eye2, np.zeros((2, 3))))
    eye3 = np.tile(np.eye(3), (3, 1, 1))
    cases.append(("resting stack", np.array([0.2, 0.2, 0.2, 0.0]),
                  np.array([1.0, 1.0, 1.0, 0.0]), eye3,
                  np.array([[0.0, 0.0999, 0.0], [0.05, 0.099, -0.1], [0.3, 0.0995, 0.2]]),
                  eye3, np.tile([0.0, -0.5, 0.0], (3, 1))))
    return cases


@pytest.fixture(scope="module")
def jax_box_box():
    return jax.jit(jax.vmap(lambda pa, pb, Ra, ta, Rb, tb_: jcol._box_box(
        pa, pb, JT(Ra, ta), JT(Rb, tb_)), in_axes=(None, None, 0, 0, 0, 0)))


@pytest.mark.parametrize("case", ["seeded", "crossing bars", "resting stack"])
def test_box_box_matches_jax(jax_box_box, case):
    name, pa, pb, Ra, ta, Rb, tb_ = next(c for c in _box_poses() if c[0] == case)
    want = [np.stack([np.asarray(x) for x in part], 1)
            for part in jax_box_box(pa, pb, Ra, ta, Rb, tb_)]
    got = [torch.stack(part, 1).numpy() for part in tcol._box_box(
        t64(pa), t64(pb), TT(t64(Ra), t64(ta)), TT(t64(Rb), t64(tb_)))]
    # an edge pair of parallel axes has no axis (its normal is 0) and is
    # never active; its point comes from a division of rounding noise by
    # the 1e-12 floor of _segment_closest_points, so only the points of
    # the other slots are compared
    axis = np.abs(want[1]).max(-1) > 0.0
    assert axis[:, :16].all()
    close(got[0][axis], want[0][axis], 1e-12)
    for g, w in zip(got[1:], want[1:]):
        close(g, w, 1e-12)
    np.testing.assert_array_equal(got[2] > 0.0, want[2] > 0.0)
    assert not (want[2] > 0.0)[~axis].any()
    active = want[2] > 0.0
    assert active.any()
    if case == "crossing bars":
        assert not active[:, :16].any() and active[:, 16:].any()
    if case == "resting stack":
        assert active[:, :16].sum() >= 4 * len(ta)
    if case == "seeded":
        assert active[:, :16].any() and active[:, 16:].any()


def test_box_box_depth_jacobian_matches_jax():
    """jacrev of the 25 depths with respect to A's position and B's
    rotation-free offset, at 8 seeded poses with vertex and edge slots
    active."""
    _, pa, pb, Ra, ta, Rb, tb_ = _box_poses()[0]
    Ra, ta, Rb, tb_ = (x[:8] for x in (Ra, ta, Rb, tb_))

    def jdepth(ta_, tb__, Ra_, Rb_):
        return jnp.stack(jcol._box_box(jnp.asarray(pa), jnp.asarray(pb), JT(Ra_, ta_),
                                       JT(Rb_, tb__))[2])

    want = jax.jit(jax.vmap(jax.jacrev(jdepth, argnums=(0, 1))))(ta, tb_, Ra, Rb)

    def tdepth(ta_, tb__, Ra_, Rb_):
        return torch.stack(tcol._box_box(t64(pa), t64(pb), TT(Ra_, ta_), TT(Rb_, tb__))[2])

    got = torch.func.vmap(torch.func.jacrev(tdepth, argnums=(0, 1)))(
        t64(ta), t64(tb_), t64(Ra), t64(Rb))
    for g, w in zip(got, want):
        close(g, np.asarray(w), 1e-12)
    assert np.abs(np.asarray(want[0])).max() > 0.5


# --------------------------------------------------------- rollout and loss


def test_catapult_rollout_and_loss_gradient_match_jax(models):
    """The example's loss over a B = 2, T = 10 rollout from the projectile
    on the arm under controls of std 50, and its gradient with respect to
    the controls (the LCP's implicit rule reversed through every step)."""
    jm, pm = models
    q, v = on_arm()
    T = 10
    u = 50.0 * np.random.default_rng(0).standard_normal((2, T, 3))

    def j_loss(u_):
        def one(q_, v_, uu):
            _, traj = j_rollout(jm, JState(q_, v_), uu)
            p_end = traj.q[-1, :2]
            closest = jnp.min(jnp.sum((traj.q[:, :2] - jnp.asarray(TARGET)[None]) ** 2, axis=1))
            loss = (jnp.sum((p_end - jnp.asarray(TARGET)) ** 2) + 0.5 * closest
                    + 1e-6 * jnp.sum(uu ** 2))
            return loss, (traj.q, traj.v)

        losses, trajs = jax.vmap(one)(jnp.asarray(q), jnp.asarray(v), u_)
        return jnp.sum(losses), trajs

    (j_val, (jq, jv)), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jnp.asarray(u))

    ut = t64(u).requires_grad_(True)
    _, traj = t_rollout(pm, State(t64(q), t64(v)), ut)
    tgt = torch.tensor(TARGET, dtype=torch.float64)
    closest = ((traj.q[..., :2] - tgt) ** 2).sum(-1).amin(-1)
    loss = (((traj.q[:, -1, :2] - tgt) ** 2).sum(-1) + 0.5 * closest
            + 1e-6 * (ut ** 2).sum((-2, -1))).sum()
    loss.backward()
    close(traj.q, jq, 1e-9)
    close(traj.v, jv, 1e-9)
    close(loss, j_val, 1e-9)
    close(ut.grad, j_grad, 1e-8)
    assert float(np.abs(np.asarray(j_grad)).max()) > 0.0


# ------------------------------------------------------------ the LCP methods


def _hard_lcp():
    """tests/test_lcp_robustness.py's near-degenerate LCP (12 rows of rank
    4 plus 1e-6 I)."""
    rng = np.random.default_rng(0)
    m = 12
    G = rng.standard_normal((m, 4))
    return (G @ G.T + 1e-6 * np.eye(m), rng.standard_normal(m), np.zeros(m),
            np.full(m, 1e20), np.zeros(m), np.zeros(m), (-1,) * m)


def _worm_goldens(n=6):
    """The worm's first n m = 28 LCPs of tests/golden/world_lcp_golden.npz,
    batched, from a zero start."""
    import os

    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "world_lcp_golden.npz"))
    ps = [p for p in range(int(d["n_problems"])) if "jump_worm" in str(d[f"w{p}_name"])][:n]
    get = lambda k: np.stack([d[f"w{p}_{k}"] for p in ps])  # noqa: E731
    A, b, lo, hi, fs = (get(k) for k in ("A", "b", "lo", "hi", "fscale"))
    return A, b, lo, hi, fs, np.zeros_like(b), tuple(int(f) for f in d[f"w{ps[0]}_findex"])


LCP_CASES = {"hard": (_hard_lcp, 6), "worm": (_worm_goldens, 60)}


@pytest.mark.parametrize("case, method", [
    ("hard", "staged"), ("hard", "jacobi"), ("hard", "gs"), ("hard", "direct"),
    ("worm", "staged"), ("worm", "jacobi"), ("worm", "gs")])
def test_lcp_methods_match_jax(case, method):
    """boxed_lcp(method=...) against the JAX boxed_lcp at the same sweeps,
    and staged_solve / jacobi_solve called directly likewise ("direct"
    only on the hard LCP: it ignores the worm's friction coupling)."""
    make, iters = LCP_CASES[case]
    A, b, lo, hi, fs, x0, findex = make()
    batched = b.ndim == 2
    args = tuple(jnp.asarray(a) for a in (A, b, lo, hi, fs, x0))

    def one(*a):
        return jl.boxed_lcp(*a, findex, iters, method)

    want = np.asarray(jax.jit(jax.vmap(one) if batched else one)(*args))
    got = tl.boxed_lcp(*(t64(a) for a in (A, b, lo, hi, fs, x0)), findex, iters, method)
    close(got, want, 1e-9)
    direct = {"staged": (tl.staged_solve, jl.staged_solve),
              "jacobi": (tl.jacobi_solve, jl.jacobi_solve)}.get(method)
    if direct is not None:
        assert torch.equal(direct[0](*(t64(a) for a in (A, b, lo, hi, fs, x0)), findex, iters),
                           got)
    if case == "hard" and method == "staged":
        res = lambda x: float(tl.lcp_residual(  # noqa: E731
            t64(A), x, *(t64(a) for a in (b, lo, hi, fs)), findex))
        short = tl.pgs_solve(*(t64(a) for a in (A, b, lo, hi, fs, x0)), findex, iters)
        assert res(got) < res(short) and res(got) < 1e-4


def test_staged_gates_only_the_lcps_that_need_it():
    """The worm's goldens at 6 sweeps, three from zero and three from the
    reference's own answers: staged_solve sends on exactly the LCPs whose
    residual after the first stage exceeds tol, and its answer for each is
    the one it gives that LCP alone, as the JAX package's lax.cond does for
    one world."""
    A, b, lo, hi, fs, _, findex = _worm_goldens()
    import os

    d = np.load(os.path.join(os.path.dirname(__file__), "golden", "world_lcp_golden.npz"))
    ps = [p for p in range(int(d["n_problems"])) if "jump_worm" in str(d[f"w{p}_name"])][:6]
    x_ref = np.stack([d[f"w{p}_x_ref"] for p in ps])
    t = [t64(a) for a in (A, b, lo, hi, fs)]
    start = torch.cat([torch.zeros(3, b.shape[1], dtype=torch.float64), t64(x_ref[3:])])
    x = tl.staged_solve(*t, start, findex, 6)
    n_deep, n_direct = tl.staged_solve.gated
    r1 = tl.lcp_residual(t[0], tl.pgs_solve(*t, start, findex, 6), *t[1:], findex)
    assert n_deep == int((r1 > 1e-8).sum()) and 3 <= n_deep < 6
    assert n_direct <= n_deep
    for k in range(len(b)):
        one = tl.staged_solve(*(a[k] for a in t), start[k], findex, 6)
        close(x[k], one, 1e-9)


# --------------------------------------------------- contact_step accuracy


def test_contact_step_staged_residual_on_catapult(models):
    """contact_step(accuracy="staged") with the projectile on the arm and
    the tails driven: its residual is at most the standard step's at the
    same sweep count, every world with a box/box slot active."""
    _, pm = models
    q, v = on_arm()
    s = State(t64(q), t64(v))
    tau = pm.action_to_tau(t64(np.array([[60.0, -40.0, 30.0], [-20.0, 50.0, 10.0]])))
    # 20 sweeps a stage (200 in the deep one) keep the CPU's plain PGS short
    out_s, info_s = tc.contact_step(pm, s, tau, lcp_iters=20, return_info=True)
    out_g, info_g = tc.contact_step(pm, s, tau, lcp_iters=20, return_info=True,
                                    accuracy="staged")
    assert bool(info_g.contacts.active[:, :25].any(-1).all())
    assert bool((info_g.residual <= info_s.residual).all())
    assert bool(torch.isfinite(out_g.v).all())
    with pytest.raises(ValueError, match="accuracy"):
        tc.contact_step(pm, s, tau, accuracy="exact")


# ----------------------------------------------------------- World / timestep


def test_world_and_timestep_match_jax(models):
    jm, pm = models
    q, v = on_arm(3)
    u = 40.0 * np.random.default_rng(1).standard_normal((3, 3))
    jw = JWorld(jm, JState(jnp.asarray(q[0]), jnp.asarray(v[0])))
    pw = World(pm, State(t64(q[0]), t64(v[0])), device="cpu")
    for k in range(3):
        jw.step(u[k])
        pw.step(u[k])
    assert len(pw.recording) == len(jw.recording) == 3 and pw.frame == 3
    close(pw.recording.poses(), jw.recording.poses(), 1e-9)
    close(pw.recording.vels(), jw.recording.vels(), 1e-9)
    close(pw.get_state(), jw.get_state(), 1e-9)
    assert pw.time == pytest.approx(jw.time, rel=1e-15)
    # World.state_jacobian's own function of the JAX package, jitted (its
    # eager jacrev takes ~45 s here)
    j_jac = jax.jit(jax.jacrev(lambda x, a: j_step(jm, JState.from_flat(x), a).flat()))
    close(pw.state_jacobian(u[0]), j_jac(jw.get_state(), jnp.asarray(u[0])), 1e-9)
    # d(next flat state)/d(action): dq'/da = 0 (q' takes the pre-step v), dv'/da
    # step_jacobians' force_vel (held to the JAX package by
    # tests/test_torch_neural.py)
    ja = pw.action_jacobian(u[0])
    assert bool((ja[:5] == 0.0).all())
    close(ja[5:], step_jacobians(pm, pw.state, t64(u[0])).force_vel, 1e-12)
    # the batched timestep against the JAX World's step, world by world
    nxt = timestep(pm, State(t64(q), t64(v)), t64(u))
    for k in range(3):
        jw.set_state(np.concatenate([q[k], v[k]]))
        close(nxt.flat()[k], jw.step(u[k], record=False).flat(), 1e-9)
    pw.reset()
    assert len(pw.recording) == 0 and pw.frame == 0 and pw.time == 0.0
    pw.set_positions(q[1])
    pw.set_velocities(v[1] + 0.1)
    assert torch.equal(pw.get_positions(), t64(q[1]))
    assert torch.equal(pw.get_velocities(), t64(v[1] + 0.1))
    assert pw.action_size == 3 and pw.get_state().device.type == "cpu"
