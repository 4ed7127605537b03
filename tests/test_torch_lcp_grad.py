"""The port's implicit boxed-LCP derivative and what it makes possible,
against the JAX package, f64 on the CPU:

  * boxed_lcp's jvp against the JAX custom_jvp and its vjp against
    jax.vjp (rel 1e-10): the direct solve at m = 4, Gauss-Seidel with
    friction coupling at m = 6, and tests/golden/world_lcp_golden.npz's
    systems (the jump worm's m = 28, the pseudoinverse branch, and the
    limited cartpole's m = 4); a dot-product test of the transpose
    (1e-12) and a finite-difference twin (utils/fd.py, rel 1e-6);
  * the solve reached on plain tensors under jacfwd, vmap and backward,
    the vmapped dimension folded into one batch (K7's route on the card);
  * jacfwd and jacrev of the full step against jax.jacfwd (rel 1e-9), on
    the limited cartpole and on two jump-worm states;
  * ilqr_solve_batch without classes on the limited cartpole against the
    JAX ilqr_solve_batch (B = 2, T = 10, 3 iterations: cost rel 1e-10, u
    1e-9), and the port's ilqr_solve against it;
  * the port's MPC planning on the limits against the JAX MPC over a cold
    and a warm replan (u at 1e-9).

One jitted JAX reference per case."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.models.model import State as JState
from nimblephysics_tpu.ops import lcp as jl
from nimblephysics_tpu.realtime.mpc import MPC as JMPC
from nimblephysics_tpu.realtime.mpc import MPCConfig as JMPCConfig
from nimblephysics_tpu.simulation.step import step as jstep
from nimblephysics_tpu.trajectory.ilqr import ILQRConfig as JConfig
from nimblephysics_tpu.trajectory.ilqr import ilqr_solve_batch as j_solve_batch

from nimblephysics_tpu_torch.models.model import State
from nimblephysics_tpu_torch.ops import cuda_lcp
from nimblephysics_tpu_torch.ops import lcp as tl
from nimblephysics_tpu_torch.ops.contact import contact_step
from nimblephysics_tpu_torch.realtime import MPC, MPCConfig
from nimblephysics_tpu_torch.simulation.step import step
from nimblephysics_tpu_torch.trajectory.ilqr import ILQRConfig, ilqr_solve, ilqr_solve_batch
from nimblephysics_tpu_torch.utils.fd import fd_jacobian

from test_torch_contact import lcp_systems
from test_torch_realtime import jax_costs, port_costs
from torch_port_helpers import jax_cartpole_costs, port_cartpole_costs, t64, to_port

RTOL = 1e-10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "world_lcp_golden.npz")
# golden systems: jump-worm steps (m = 28, 9 and 6 clamping rows) and
# limited-cartpole steps (m = 4)
WORM_GOLDEN, CARTPOLE_GOLDEN = (0, 40, 120), (290, 300)


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


def golden(indices):
    d = np.load(GOLDEN)
    keys = ("A", "b", "lo", "hi", "fscale")
    arrs = [np.stack([d[f"w{p}_{k}"] for p in indices]) for k in keys]
    findex = {tuple(int(v) for v in d[f"w{p}_findex"]) for p in indices}
    assert len(findex) == 1
    return (*arrs, findex.pop())


# (systems, method, sweeps) per case
LCP_CASES = {
    "direct_m4": (lambda: lcp_systems(4, seed=4), "direct", 3),
    "gs_m6_friction": (lambda: lcp_systems(6, seed=6), "gs", 60),
    "golden_worm_m28": (lambda: golden(WORM_GOLDEN), "gs", 60),
    "golden_cartpole_m4": (lambda: golden(CARTPOLE_GOLDEN), "direct", 3),
}


@pytest.fixture(scope="module", params=list(LCP_CASES))
def lcp_case(request):
    """The systems, seeded tangents (dA, db) and cotangent g, and the JAX
    references: x, the jvp and the vjp (gA, gb), all under one jit."""
    make, method, iters = LCP_CASES[request.param]
    A, b, lo, hi, fs, findex = make()
    rng = np.random.default_rng(20)
    dA, db, g = (rng.standard_normal(A.shape), rng.standard_normal(b.shape),
                 rng.standard_normal(b.shape))

    def one(A, b, lo, hi, fs, dA, db, g):
        def f(A_, b_):
            return jl.boxed_lcp(A_, b_, lo, hi, fs, jnp.zeros_like(b_), findex, iters, method)

        x, dx = jax.jvp(f, (A, b), (dA, db))
        gA, gb = jax.vjp(f, A, b)[1](g)
        return x, dx, gA, gb

    ref = jax.jit(jax.vmap(one))(*map(jnp.asarray, (A, b, lo, hi, fs, dA, db, g)))
    return dict(name=request.param, method=method, iters=iters, findex=findex,
                args=tuple(map(t64, (A, b, lo, hi, fs))), dA=t64(dA), db=t64(db), g=t64(g),
                ref=[np.asarray(r) for r in ref])


def port_solve(case, kernels=True):
    _, _, lo, hi, fs = case["args"]

    def f(A_, b_):
        return tl.boxed_lcp(A_, b_, lo, hi, fs, torch.zeros_like(b_), case["findex"],
                            case["iters"], case["method"], kernels=kernels)

    return f


def test_boxed_lcp_jvp_matches_jax(lcp_case):
    A, b = lcp_case["args"][:2]
    x, dx = torch.func.jvp(port_solve(lcp_case), (A, b), (lcp_case["dA"], lcp_case["db"]))
    close(x, lcp_case["ref"][0], RTOL)
    close(dx, lcp_case["ref"][1], RTOL)
    # the cases have clamping and non-clamping rows, so the rule's R and Qf
    # are not the identity
    cl = tl._classify(x, *lcp_case["args"][2:], lcp_case["findex"])[0]
    assert bool(cl.any()) and not bool(cl.all())


def test_boxed_lcp_vjp_matches_jax(lcp_case):
    A, b = (a.clone().requires_grad_(True) for a in lcp_case["args"][:2])
    port_solve(lcp_case)(A, b).backward(lcp_case["g"])
    close(A.grad, lcp_case["ref"][2], RTOL)
    close(b.grad, lcp_case["ref"][3], RTOL)


def test_boxed_lcp_vjp_is_the_transpose(lcp_case):
    """<J t, g> = <t, J^T g> per system, the jvp and vjp of the port."""
    A, b = lcp_case["args"][:2]
    f = port_solve(lcp_case)
    _, dx = torch.func.jvp(f, (A, b), (lcp_case["dA"], lcp_case["db"]))
    _, vjp = torch.func.vjp(f, A, b)
    gA, gb = vjp(lcp_case["g"])
    lhs = (dx * lcp_case["g"]).sum(-1)
    rhs = (lcp_case["dA"] * gA).sum((-2, -1)) + (lcp_case["db"] * gb).sum(-1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-12,
                               atol=1e-12 * float(rhs.abs().max()))


@pytest.mark.parametrize("method", ["direct", "gs"])
def test_boxed_lcp_matches_finite_differences(method):
    """The implicit derivative against central differences (utils/fd.py) of
    the solve, on b (every column, the direct solve) and along a seeded
    direction of (A, b), on systems whose classes the FD stencil leaves
    unchanged: the direct solve at m = 4, Gauss-Seidel with friction
    coupling at m = 6, converged (600 sweeps)."""
    m, iters = (4, 3) if method == "direct" else (6, 600)
    A, b, lo, hi, fs, findex = (t64(a) if isinstance(a, np.ndarray) else a
                                for a in lcp_systems(m, seed=m))
    rng = np.random.default_rng(21)
    dA, db = t64(rng.standard_normal(A.shape)), t64(rng.standard_normal(b.shape))
    eps = 1e-6

    def solve(A_, b_):
        return tl.boxed_lcp(A_, b_, lo, hi, fs, torch.zeros_like(b_), findex, iters, method)

    for s in (-eps, eps):
        xs = solve(A + s * dA, b + s * db)
        for a_, b_ in zip(tl._classify(xs, lo, hi, fs, findex),
                          tl._classify(solve(A, b), lo, hi, fs, findex)):
            assert torch.equal(a_, b_), "the FD stencil crosses a class boundary"
    _, dx = torch.func.jvp(solve, (A, b), (dA, db))
    fd = fd_jacobian(lambda s: solve(A + float(s[0]) * dA, b + float(s[0]) * db).numpy(),
                     np.zeros(1), eps=eps)
    close(dx, fd.reshape(dx.shape), 1e-6)
    if method == "direct":
        def solve_one(A_, b_, lo_, hi_):
            return tl.boxed_lcp(A_, b_, lo_, hi_, torch.zeros_like(b_), torch.zeros_like(b_),
                                findex, iters, method)

        jac = torch.func.vmap(torch.func.jacfwd(solve_one, argnums=1))(A, b, lo, hi)
        for n in range(A.shape[0]):
            fd_b = fd_jacobian(lambda bb: solve_one(A[n], t64(bb), lo[n], hi[n]).numpy(),
                               b[n].numpy(), eps=eps)
            close(jac[n], fd_b, 1e-6)


def test_solve_runs_on_plain_tensors_under_transforms(monkeypatch):
    """Under jacfwd, vmap(jacfwd) and backward, boxed_lcp(method="gs")
    reaches K7's wrapper (pgs_batched, whose plain version runs on CPU
    tensors) once per call, with plain tensors and the whole batch: the
    vmapped dimension folded into the LCP batch, the tangent directions
    never. kernels=False takes pgs_solve and never the wrapper."""
    A, b, lo, hi, fs, findex = (t64(a) if isinstance(a, np.ndarray) else a
                                for a in lcp_systems(6, seed=6))
    seen = []
    plain = cuda_lcp.pgs_batched_plain

    def recording(A_, b_, *rest, **kw):
        for t in (A_, b_) + rest[:4]:
            assert not torch._C._functorch.is_functorch_wrapped_tensor(t)
            assert not t.requires_grad
        seen.append(tuple(b_.shape))
        return plain(A_, b_, *rest, **kw)

    monkeypatch.setattr(cuda_lcp, "pgs_batched_plain", recording)

    def solve(A_, b_, kernels=True):
        return tl.boxed_lcp(A_, b_, lo[0], hi[0], fs[0], torch.zeros_like(b_), findex, 60, "gs",
                            kernels=kernels)

    jac_v = torch.func.vmap(torch.func.jacfwd(solve, argnums=(0, 1)))(A, b)
    assert seen == [tuple(b.shape)]
    jac_1 = torch.func.jacfwd(solve, argnums=(0, 1))(A[2], b[2])
    assert seen[1:] == [(6,)]
    close(jac_v[0][2], jac_1[0], 1e-13)
    close(jac_v[1][2], jac_1[1], 1e-13)
    Ag = A.clone().requires_grad_(True)
    solve(Ag, b).sum().backward()
    assert seen[2:] == [tuple(b.shape)] and torch.isfinite(Ag.grad).all()
    jac_p = torch.func.vmap(torch.func.jacfwd(lambda a, bb: solve(a, bb, False),
                                              argnums=(0, 1)))(A, b)
    assert len(seen) == 3
    assert torch.equal(jac_p[0], jac_v[0]) and torch.equal(jac_p[1], jac_v[1])


def test_direct_solve_of_closed_boxes_is_zero():
    """Every row boxed to [0, 0] (a limits-only step inside its limits):
    boxed_lcp returns 0 without running the direct solve, which returns the
    same +0.0, and so does the rule's tangent."""
    A, b, _, _, _, _ = (t64(a) if isinstance(a, np.ndarray) else a
                        for a in lcp_systems(4, seed=1))
    z = torch.zeros_like(b)
    x, dx = torch.func.jvp(lambda b_: tl.boxed_lcp(A, b_, z, z, z, z, (-1,) * 4, 3, "direct"),
                           (b,), (torch.ones_like(b),))
    ref = tl.direct_boxed_solve(A, b, z, z)
    assert torch.equal(x, ref) and not bool(torch.signbit(ref).any())
    assert torch.equal(dx, z)


def test_boxed_lcp_refuses_unported_methods():
    """Every method of the JAX package is ported ("jacobi" and "staged"
    give jacobi_solve's and staged_solve's answers); any other name is
    refused."""
    A, b, lo, hi, _, _ = (t64(a) if isinstance(a, np.ndarray) else a
                          for a in lcp_systems(4, seed=1))
    z = torch.zeros_like(b)
    for method, fn in (("jacobi", tl.jacobi_solve), ("staged", tl.staged_solve)):
        assert torch.equal(tl.boxed_lcp(A, b, lo, hi, z, z, (-1,) * 4, 60, method),
                           fn(A, b, lo, hi, z, z, (-1,) * 4, 60))
    with pytest.raises(ValueError, match="unknown method"):
        tl.boxed_lcp(A, b, lo, hi, z, z, (-1,) * 4, 60, "dantzig")


# ------------------------------------------------------------- the full step


def cartpole_points():
    """The stock cartpole (limits: cart +-1 m, pole +-1.57 rad) at states
    pushed into and past its limits, with actions."""
    mj = jb.cartpole(dt=0.02)
    x = np.array([[1.02, 0.3, 0.5, -1.0], [-0.99, 1.6, -1.2, 2.0], [0.98, -1.58, 0.4, -0.5],
                  [0.2, 0.1, 0.0, 0.3]])
    u = np.array([[8.0], [-6.0], [3.0], [1.0]])
    return mj, x, u


def worm_points():
    """Two jump-worm states from its drop, feet on and above the floor."""
    mj = jb.jump_worm(dt=0.001)
    rng = np.random.default_rng(2)
    q = np.zeros((2, 4))
    q[:, 1] = [-0.5, -0.56]
    q = q + 0.02 * rng.standard_normal((2, 4))
    x = np.concatenate([q, 0.3 * rng.standard_normal((2, 4))], 1)
    return mj, x, 5.0 * rng.standard_normal((2, 2))


@pytest.fixture(scope="module", params=["cartpole", "worm"])
def step_case(request):
    mj, x, u = cartpole_points() if request.param == "cartpole" else worm_points()

    def jdyn(x, u):
        return jstep(mj, JState.from_flat(x), u).flat()

    ref = jax.jit(jax.vmap(jax.jacfwd(jdyn, argnums=(0, 1))))(jnp.asarray(x), jnp.asarray(u))
    mt = to_port(mj)

    def tdyn(x, u):
        return step(mt, State.from_flat(x), u).flat()

    return dict(name=request.param, mt=mt, x=t64(x), u=t64(u), dyn=tdyn,
                ref=[np.asarray(r) for r in ref])


@pytest.mark.parametrize("mode", ["jacfwd", "jacrev"])
def test_step_jacobians_match_jax(step_case, mode):
    """fx, fu of the port's full constrained step, forward mode (the
    linearization iLQR takes) and reverse mode (a loss gradient), against
    jax.jacfwd of the JAX step."""
    jac = getattr(torch.func, mode)(step_case["dyn"], argnums=(0, 1))
    fx, fu = torch.func.vmap(jac)(step_case["x"], step_case["u"])
    close(fx, step_case["ref"][0], 1e-9)
    close(fu, step_case["ref"][1], 1e-9)
    # the points have constraint rows on, so the LCP's rule moves fx
    _, info = contact_step(step_case["mt"], State.from_flat(step_case["x"]),
                           step_case["mt"].action_to_tau(step_case["u"]), return_info=True)
    assert bool(info.clamping.any())


# ----------------------------------------------------------- iLQR and MPC

B, T, ITERS = 2, 10, 3


@pytest.fixture(scope="module")
def ilqr_case():
    """The stock cartpole planned on its limits from carts near +1 m and
    random controls (the rollouts press the cart into its limit)."""
    mj = jb.cartpole(dt=0.02)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, (B, 4))
    x0[:, 0] += 0.9
    u0 = 5.0 * rng.uniform(-1.0, 1.0, (B, T, 1))
    run_j, fin_j = jax_cartpole_costs(mj.nq)
    sol_j = j_solve_batch(mj, jnp.asarray(x0), jnp.asarray(u0), run_j, fin_j,
                          JConfig(iters=ITERS, unroll=1), block_b=8)
    mt = to_port(mj)
    run_t, fin_t = port_cartpole_costs(mt)
    sol_t = ilqr_solve_batch(mt, t64(x0), t64(u0), run_t, fin_t,
                             ILQRConfig(iters=ITERS, kernels=False))
    return dict(mt=mt, x0=x0, u0=u0, sol_j=sol_j, sol_t=sol_t, costs=(run_t, fin_t))


def test_ilqr_full_step_matches_jax(ilqr_case):
    sol_t, sol_j = ilqr_case["sol_t"], ilqr_case["sol_j"]
    np.testing.assert_allclose(sol_t.cost.numpy(), np.asarray(sol_j.cost), rtol=1e-10)
    np.testing.assert_allclose(sol_t.cost_history.numpy(), np.asarray(sol_j.cost_history),
                               rtol=1e-10)
    np.testing.assert_allclose(sol_t.u.numpy(), np.asarray(sol_j.u), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=1e-9, atol=1e-9)
    # the plan presses the cart into its limit, and every world improves
    assert float(sol_t.x[..., 0].abs().max()) > 1.0
    hist = sol_t.cost_history.numpy()
    assert (np.diff(hist, axis=0) <= 0).all() and (hist[-1] < hist[0]).all()


def test_ilqr_full_step_configs_and_single_world(ilqr_case):
    """kernels=True on CPU tensors takes the same plain functions; the
    per-world ilqr_solve takes the same iterations."""
    run_t, fin_t = ilqr_case["costs"]
    mt, x0, u0 = ilqr_case["mt"], ilqr_case["x0"], ilqr_case["u0"]
    sol = ilqr_solve_batch(mt, t64(x0), t64(u0), run_t, fin_t, ILQRConfig(iters=ITERS))
    assert torch.equal(sol.u, ilqr_case["sol_t"].u)
    one = ilqr_solve(mt, State.from_flat(t64(x0[1])), t64(u0[1]), run_t, fin_t,
                     ILQRConfig(iters=ITERS))
    np.testing.assert_allclose(one.u.numpy(), ilqr_case["sol_t"].u[1].numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(one.cost_history.numpy(),
                               ilqr_case["sol_t"].cost_history[:, 1].numpy(), rtol=1e-10)


def test_mpc_plans_on_limits_as_jax():
    """Both MPCs plan on the limited cartpole itself (no planning model),
    from a cart at 0.98 m moving outward: a cold replan, one plant step, a
    warm replan half a step later."""
    H, iters, dt = 8, 2, 0.02
    mj = jb.cartpole(dt=dt)
    mt = to_port(mj)
    jmpc = JMPC(mj, *jax_costs(), JMPCConfig(horizon=H, replan_iters=iters,
                                             first_solve_iters=iters, unroll=1))
    # the cold and the warm replan take the same iterations: one compile
    jmpc._replan_warm = jmpc._replan_cold
    tmpc = MPC(mt, *port_costs(mt), MPCConfig(horizon=H, replan_iters=iters,
                                              first_solve_iters=iters), device="cpu")
    state = State(q=t64([0.98, 0.2]), v=t64([1.5, -0.5]))
    plans = []
    t = 0.0
    for now in (0.0, 1.5 * dt):
        if now > 0.0:
            state = step(mt, state, tmpc.control_now(t, state))
            t += dt
        jmpc.record_state(t, JState(q=jnp.asarray(state.q.numpy()),
                                    v=jnp.asarray(state.v.numpy())))
        tmpc.record_state(t, state)
        jmpc.replan_at(now)
        tmpc.replan_at(now)
        plans.append((jmpc.plan, tmpc.plan))
    for pj, pt in plans:
        assert pt.start_time == pytest.approx(pj.start_time, abs=1e-12)
        for field in ("u", "x_ref", "K"):
            np.testing.assert_allclose(getattr(pt, field).numpy(),
                                       np.asarray(getattr(pj, field)), rtol=1e-9, atol=1e-9)
    # the plans run the cart into its limit row
    assert max(float(pt.x_ref[:, 0].abs().max()) for _, pt in plans) >= 1.0
