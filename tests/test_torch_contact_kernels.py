"""The contact path's kernels (their plain versions, which the CPU runs) and
the contact replan against the JAX package, on the cartpole with the
narrowed limits of tests/test_frozen_contact.py started into them, B=4,
T=10, the JAX Pallas kernels in interpret mode with block_b=128:

  * K6 rollout_classes against rollout_classes_pallas: states rel 1e-10,
    classes identical;
  * K4 linearize_split: f64 against jacfwd of the JAX package's
    dyn_frozen_for_trace at rel 1e-9 (linearize_pallas_split itself packs
    its primal boundary in f32 and is f32-accurate even in f64), also at
    one PCG iteration with two rows clamping, where only the implicit
    tangent passes; in f32 at cg_iters=4 against linearize_pallas_split at
    rel 2e-4;
  * K3 linearize(classes=) (K4 at the frozen solve's default PCG depth
    m + 6, as linearize_pallas(classes=) takes it): f64 against the same
    jacfwd at rel 1e-9, f32 against linearize_pallas(classes=) at rel 2e-4;
    ILQRConfig(linearize="jvp") takes that depth whatever planner_cg_iters
    is;
  * K2 rollout_gains with classes against rollout_gains_pallas(classes=)
    at rel 1e-10;
  * solve_contact_mpc_batch against the JAX one (2 iterations, one outer
    iteration; the JAX side with linearize="xla", its f64-exact
    linearization): u, x, cost, cost history and the returned classes at
    rel 1e-8; the port's replan with linearize="jvp" against the same JAX
    replan (whose "xla" linearize is the same function: jacfwd at depth
    m + 6) on u, x and cost at rel 1e-9;
  * the port's one-world solvers against its batch solver, and the options
    not ported yet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.ops.pallas_linearize import dyn_frozen_for_trace as j_dyn_frozen
from nimblephysics_tpu.ops.pallas_linearize import linearize_pallas, linearize_pallas_split
from nimblephysics_tpu.ops.pallas_rollout import rollout_classes_pallas, rollout_gains_pallas
from nimblephysics_tpu.trajectory.ilqr import ILQRConfig as JConfig
from nimblephysics_tpu.trajectory.ilqr import solve_contact_mpc_batch as j_contact_mpc

from nimblephysics_tpu_torch.models.model import State
from nimblephysics_tpu_torch.ops import frozen_contact as tf
from nimblephysics_tpu_torch.ops import cuda_linearize
from nimblephysics_tpu_torch.ops.cuda_linearize import linearize, linearize_split
from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_classes, rollout_gains
from nimblephysics_tpu_torch.trajectory import ilqr as ilqr_mod
from nimblephysics_tpu_torch.trajectory.ilqr import (
    ILQRConfig,
    ilqr_solve,
    ilqr_solve_batch,
    solve_contact_mpc,
    solve_contact_mpc_batch,
)

from torch_port_helpers import (
    iterate_through_pcg,
    jax_cartpole_costs,
    port_cartpole_costs,
    t64,
    to_port,
)

B, T, ITERS = 4, 10, 2


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1.0))


def narrowed_jax(dtype=jnp.float64):
    m = jb.cartpole(dt=0.02).replace(q_lower=jnp.asarray([-0.6, -0.5]),
                                     q_upper=jnp.asarray([0.6, 0.5]))
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, m)


@pytest.fixture(scope="module")
def case():
    """Start states into the narrowed limits (cart within +-0.55 m, pole
    within +-0.45 rad, moving at up to 2 units/s), controls that push for
    half the horizon, and the K6 Pallas rollout's trajectory and classes.
    Each JAX Pallas kernel runs under jax.jit, so that its interpret-mode
    setup is traced into one program rather than run op by op, and K6's
    program serves both of its calls."""
    mj = narrowed_jax()
    mt = to_port(mj)
    rng = np.random.default_rng(3)
    x0 = np.concatenate([rng.uniform(-0.55, 0.55, (B, 1)), rng.uniform(-0.45, 0.45, (B, 1)),
                         rng.uniform(-2.0, 2.0, (B, 2))], axis=1)
    u = np.concatenate([np.full((B, T // 2, 1), 20.0), rng.uniform(-20, 20, (B, T - T // 2, 1))],
                       axis=1)
    k6 = jax.jit(lambda x0, u: rollout_classes_pallas(mj, x0, u, block_b=128, interpret=True))
    xs_j, cl_j = k6(jnp.asarray(x0), jnp.asarray(u))
    cm = np.asarray(cl_j.cmask)
    assert cm.any() and not cm.all(), "the fixture must touch the limits"
    xs_pre = np.concatenate([x0[:, None], np.asarray(xs_j)[:, :-1]], axis=1)
    return dict(mj=mj, mt=mt, x0=x0, u=u, xs=np.asarray(xs_j), xs_pre=xs_pre, cmask=cm,
                us=np.asarray(cl_j.us), k6=k6)


def test_rollout_classes_matches_pallas(case):
    xs, cl = rollout_classes(case["mt"], t64(case["x0"]), t64(case["u"]))
    close(xs, case["xs"], 1e-10)
    np.testing.assert_array_equal(cl.cmask.numpy(), case["cmask"])
    close(cl.us, case["us"], 1e-10)


@pytest.fixture(scope="module")
def frozen_jac(case):
    """jacfwd of the JAX package's frozen step (its solve's tangent is the
    implicit one of lax.custom_linear_solve) under one jit: at the replan's
    PCG depth (m + 6) on the fixture's classes, and at one PCG iteration on
    classes with two rows clamping at every point (cart lower, pole upper),
    where the PCG stops short of the solution."""
    mj = case["mj"]
    two = np.tile([1.0, 0.0, 0.0, 1.0], (B, T, 1))
    pts = lambda a: jnp.asarray(a.reshape(B * T, -1))  # noqa: E731

    def jac(x, u, cm, us, cm2):
        full = jax.vmap(jax.jacfwd(j_dyn_frozen(mj), argnums=(0, 1)))(x, u, cm, us)
        short = jax.vmap(jax.jacfwd(j_dyn_frozen(mj, cg_iters=1), argnums=(0, 1)))(
            x, u, cm2, jnp.zeros_like(cm2))
        return full, short

    full, short = jax.jit(jac)(pts(case["xs_pre"]), pts(case["u"]), pts(case["cmask"]),
                               pts(case["us"]), pts(two))
    shape = lambda f: tuple(np.asarray(a).reshape(B, T, 4, -1) for a in f)  # noqa: E731
    return dict(full=shape(full), short=shape(short), two=two)


def test_linearize_split_matches_jacfwd_f64(case, frozen_jac):
    """K4's plain version against jacfwd of the frozen step it linearizes,
    at the PCG depth of the replan (m + 6)."""
    fx, fu = linearize_split(case["mt"], t64(case["xs_pre"]), t64(case["u"]),
                             (t64(case["cmask"]), t64(case["us"])))
    close(fx, frozen_jac["full"][0], 1e-9)
    close(fu, frozen_jac["full"][1], 1e-9)


def test_linearize_split_short_pcg_takes_the_implicit_tangent(case, frozen_jac, monkeypatch):
    """At one PCG iteration with two rows clamping, K4's plain version
    matches the JAX implicit tangent at rel 1e-9 in f64; the derivative of
    the truncated iteration, which dual numbers pushed through the PCG
    would give, is rejected by that comparison."""
    two = t64(frozen_jac["two"])
    args = (case["mt"], t64(case["xs_pre"]), t64(case["u"]), (two, torch.zeros_like(two)))
    fx, fu = linearize_split(*args, cg_iters=1)
    want_fx, want_fu = frozen_jac["short"]
    close(fx, want_fx, 1e-9)
    close(fu, want_fu, 1e-9)
    iterate_through_pcg(monkeypatch)
    fx_iter, _ = linearize_split(*args, cg_iters=1)
    gap = float((fx_iter - t64(want_fx)).abs().max()) / float(np.abs(want_fx).max())
    assert gap > 1e-3, gap


def test_linearize_split_matches_pallas_f32_cg4(case):
    """In f32 at cg_iters=4 the JAX kernel's tangent is the implicit one of
    lax.custom_linear_solve; the plain version takes the same."""
    mj32 = narrowed_jax(jnp.float32)
    mt32 = to_port(mj32)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    fx_j, fu_j = jax.jit(lambda x, u, cm, us: linearize_pallas_split(
        mj32, x, u, (cm, us), block_b=128, interpret=True, cg_iters=4))(
        f32(case["xs_pre"]), f32(case["u"]), f32(case["cmask"]), f32(case["us"]))
    t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    fx, fu = linearize_split(mt32, t32(case["xs_pre"]), t32(case["u"]),
                             (t32(case["cmask"]), t32(case["us"])), cg_iters=4)
    close(fx, fx_j, 2e-4)
    close(fu, fu_j, 2e-4)


def test_linearize_with_classes_matches_jacfwd_f64(case, frozen_jac):
    """K3's classes= form: the frozen step's jacfwd at the default depth
    m + 6 (linearize_pallas(classes=) takes no PCG depth)."""
    fx, fu = linearize(case["mt"], t64(case["xs_pre"]), t64(case["u"]),
                       classes=(t64(case["cmask"]), t64(case["us"])))
    close(fx, frozen_jac["full"][0], 1e-9)
    close(fu, frozen_jac["full"][1], 1e-9)


def test_linearize_with_classes_matches_pallas_f32(case):
    mj32 = narrowed_jax(jnp.float32)
    mt32 = to_port(mj32)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    fx_j, fu_j = jax.jit(lambda x, u, cm, us: linearize_pallas(
        mj32, x, u, block_b=128, interpret=True, classes=(cm, us)))(
        f32(case["xs_pre"]), f32(case["u"]), f32(case["cmask"]), f32(case["us"]))
    t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    fx, fu = linearize(mt32, t32(case["xs_pre"]), t32(case["u"]),
                       classes=(t32(case["cmask"]), t32(case["us"])))
    close(fx, fx_j, 2e-4)
    close(fu, fu_j, 2e-4)


def test_jvp_takes_the_default_pcg_depth(case, frozen_jac, monkeypatch):
    """ILQRConfig(linearize="jvp") linearizes at the frozen solve's default
    depth m + 6 even where planner_cg_iters is smaller, as the JAX package's
    linearize_pallas(classes=) does; "split" and "chain" take
    planner_cg_iters. At one PCG iteration with two rows clamping the two
    depths give different Jacobians."""
    from nimblephysics_tpu_torch.ops import lane_chain

    depths = []

    def spy(real):
        def plain(model, xs, u, classes, cg_iters=None):
            depths.append(cg_iters)
            return real(model, xs, u, classes, cg_iters)
        return plain

    split, vjp = cuda_linearize.linearize_split_plain, cuda_linearize.linearize_vjp_plain
    for mod in (cuda_linearize, ilqr_mod):
        monkeypatch.setattr(mod, "linearize_split_plain", spy(split))
    for mod in (cuda_linearize, lane_chain):
        monkeypatch.setattr(mod, "linearize_vjp_plain", spy(vjp))
    run_t, fin_t = port_cartpole_costs(case["mt"])
    args = (case["mt"], t64(case["x0"]), torch.zeros(B, T, 1, dtype=torch.float64), run_t,
            fin_t)
    cl = (t64(case["cmask"]), t64(case["us"]))
    for mode in ("jvp", "split", "chain"):
        for kernels in (True, False):
            ilqr_solve_batch(*args, ILQRConfig(iters=1, linearize=mode, planner_cg_iters=1,
                                               kernels=kernels), classes=cl)
    assert depths == [None, None, 1, 1, 1, 1]
    two = t64(frozen_jac["two"])
    x, u = t64(case["xs_pre"]), t64(case["u"])
    fx, _ = linearize(case["mt"], x, u, classes=(two, torch.zeros_like(two)))
    fx1, _ = split(case["mt"], x, u, (two, torch.zeros_like(two)), 1)
    assert float((fx - fx1).abs().max()) > 1e-6


def test_rollout_gains_with_classes_matches_pallas(case):
    rng = np.random.default_rng(7)
    K = 0.5 * rng.standard_normal((B, T, 1, 4))
    k = rng.standard_normal((B, T, 1))
    alphas = np.array([1.0, 0.3, 0.01])
    xs_ref = np.concatenate([case["x0"][:, None], case["xs"]], axis=1)
    run_j, fin_j = jax_cartpole_costs(2)
    want = jax.jit(lambda x0, xs, u, K, k, al, cm, us: rollout_gains_pallas(
        case["mj"], run_j, fin_j, x0, xs, u, K, k, al, block_b=128, interpret=True,
        classes=(cm, us)))(*map(jnp.asarray, (case["x0"], xs_ref, case["u"], K, k, alphas,
                                             case["cmask"], case["us"])))
    run_t, fin_t = port_cartpole_costs(case["mt"])
    got = rollout_gains(case["mt"], run_t, fin_t,
                        *map(t64, (case["x0"], xs_ref, case["u"], K, k, alphas)),
                        classes=(t64(case["cmask"]), t64(case["us"])))
    for g, w in zip(got, want):
        close(g, w, 1e-10)


@pytest.fixture(scope="module")
def mpc(case):
    """Both replans from u0 = 0, seeded with the classes of u0's full-LCP
    rollout as K6 gives them (its Pallas form on the JAX side, which
    test_rollout_classes_matches_pallas holds the port's to); with one
    outer iteration that is the class refresh of classes=None, which
    test_plain_config_matches_kernel_config_on_cpu checks on the port."""
    run_j, fin_j = jax_cartpole_costs(2)
    mj = case["mj"]
    u0 = np.zeros((B, T, 1))
    _, cl0 = case["k6"](jnp.asarray(case["x0"]), jnp.asarray(u0))
    solve = jax.jit(lambda x0, u0, cm, us: j_contact_mpc(
        mj, x0, u0, run_j, fin_j, JConfig(iters=ITERS, linearize="xla", unroll=1),
        outer_iters=1, block_b=128, classes=type(cl0)(cmask=cm, us=us)))
    sol_j, cl_j = solve(jnp.asarray(case["x0"]), jnp.asarray(u0), cl0.cmask, cl0.us)
    run_t, fin_t = port_cartpole_costs(case["mt"])
    cl0_t = tf.FrozenClasses(t64(cl0.cmask), t64(cl0.us))
    sol_t, cl_t = solve_contact_mpc_batch(case["mt"], t64(case["x0"]), t64(u0), run_t, fin_t,
                                          ILQRConfig(iters=ITERS), outer_iters=1, classes=cl0_t)
    return dict(sol_j=sol_j, cl_j=cl_j, sol_t=sol_t, cl_t=cl_t, costs=(run_t, fin_t), cl0=cl0_t)


@pytest.mark.parametrize("field", ["u", "x", "cost", "cost_history", "K", "k"])
def test_solve_contact_mpc_batch_matches_jax(mpc, field):
    close(getattr(mpc["sol_t"], field), getattr(mpc["sol_j"], field), 1e-8)


@pytest.fixture(scope="module")
def mpc_jvp(case, mpc):
    run_t, fin_t = mpc["costs"]
    sol, _ = solve_contact_mpc_batch(case["mt"], t64(case["x0"]),
                                     torch.zeros(B, T, 1, dtype=torch.float64), run_t, fin_t,
                                     ILQRConfig(iters=ITERS, linearize="jvp"), outer_iters=1,
                                     classes=mpc["cl0"])
    return sol


@pytest.mark.parametrize("field", ["u", "x", "cost"])
def test_solve_contact_mpc_batch_jvp_matches_jax(mpc, mpc_jvp, field):
    """The replan with linearize="jvp" against the JAX replan of the mpc
    fixture (linearize="xla", jacfwd of the frozen step at depth m + 6: the
    function "jvp" computes)."""
    close(getattr(mpc_jvp, field), getattr(mpc["sol_j"], field), 1e-9)


def test_solve_contact_mpc_batch_classes_match_jax(mpc):
    np.testing.assert_array_equal(mpc["cl_t"].cmask.numpy(), np.asarray(mpc["cl_j"].cmask))
    close(mpc["cl_t"].us, mpc["cl_j"].us, 1e-8)
    assert mpc["cl_t"].cmask.any()
    hist = mpc["sol_t"].cost_history.numpy()
    assert (np.diff(hist, axis=0) <= 0).all()


def test_plain_config_matches_kernel_config_on_cpu(case, mpc):
    """classes=None refreshes the classes from u0's rollout (K6), and
    kernels=False takes the plain versions: on the CPU both give the
    seeded solve's result."""
    run_t, fin_t = mpc["costs"]
    for cfg in (ILQRConfig(iters=ITERS), ILQRConfig(iters=ITERS, kernels=False)):
        sol, cl = solve_contact_mpc_batch(case["mt"], t64(case["x0"]),
                                          torch.zeros(B, T, 1, dtype=torch.float64), run_t,
                                          fin_t, cfg, outer_iters=1)
        assert torch.equal(sol.u, mpc["sol_t"].u)
        assert torch.equal(cl.cmask, mpc["cl_t"].cmask)


def test_ilqr_solve_with_classes_matches_batch(case, mpc):
    """The one-world sequential reference on the same frozen classes takes
    the same iterations as the batch solver."""
    run_t, fin_t = mpc["costs"]
    mt = case["mt"]
    _, cl = rollout_classes(mt, t64(case["x0"]), torch.zeros(B, T, 1, dtype=torch.float64))
    for b in (0, B - 1):
        sol = ilqr_solve(mt, State.from_flat(t64(case["x0"][b])),
                         torch.zeros(T, 1, dtype=torch.float64), run_t, fin_t,
                         ILQRConfig(iters=ITERS), tf.FrozenClasses(cl.cmask[b], cl.us[b]))
        close(sol.u, mpc["sol_t"].u[b], 1e-9)
        close(sol.cost_history, mpc["sol_t"].cost_history[:, b], 1e-9)


def test_solve_contact_mpc_one_world(case, mpc):
    """The one-world contact MPC: its inner solve on the classes of u0's
    full-LCP rollout, its cost on the true constrained dynamics."""
    run_t, fin_t = mpc["costs"]
    mt = case["mt"]
    x0 = State.from_flat(t64(case["x0"][0]))
    u0 = torch.zeros(T, 1, dtype=torch.float64)
    sol, cl = solve_contact_mpc(mt, x0, u0, run_t, fin_t, ILQRConfig(iters=ITERS), outer_iters=1)
    _, _, cl0, _ = tf.rollout_classes(mt, x0, u0)
    inner = ilqr_solve(mt, x0, u0, run_t, fin_t, ILQRConfig(iters=ITERS), cl0)
    close(sol.u, inner.u, 1e-12)
    _, traj = tf.rollout_classes(mt, x0, sol.u)[:2]
    close(sol.x[1:], torch.cat([traj.q, traj.v], -1), 1e-12)
    ts = torch.arange(T)
    want = torch.func.vmap(run_t)(sol.x[:-1], sol.u, ts).sum() + fin_t(sol.x[-1])
    close(sol.cost, want, 1e-12)
    assert cl.cmask.shape == (T, 4)


def test_contact_options_not_ported_raise(case, mpc):
    run_t, fin_t = mpc["costs"]
    args = (case["mt"], t64(case["x0"]), torch.zeros(B, T, 1, dtype=torch.float64), run_t, fin_t)
    with pytest.raises(ValueError, match="class_refresh"):
        solve_contact_mpc_batch(*args, class_refresh="scan")
    with pytest.raises(NotImplementedError, match="M2/M3/M5"):
        solve_contact_mpc_batch(*args, ILQRConfig(linearize="xla"))
    # without classes a model with rows plans on the full constrained step
    # (its JAX parity: tests/test_torch_lcp_grad.py), kernels or not
    sol = ilqr_solve_batch(*args, ILQRConfig(iters=1))
    assert sol.u.shape == (B, T, 1) and bool(torch.isfinite(sol.cost).all())
    assert torch.equal(sol.u, ilqr_solve_batch(*args, ILQRConfig(iters=1, kernels=False)).u)
