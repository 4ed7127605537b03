"""The worm path's kernels (their plain versions, which the CPU runs)
against the JAX package:

  * K5 linearize_vjp: f64 against jax.jacrev of the v' half of the JAX
    package's dyn_frozen_for_trace, rel 1e-9 (the q' rows analytic, [I, dt I]
    and 0, exactly); in f32 against linearize_pallas_vjp in interpret mode
    (block_b=128) at rel 2e-4 (the kernel's own f64 is f32-accurate: it
    packs its primal boundary in f32, ROADMAP queue C);
  * K5 at a PCG depth below the clamping rows: jax.jacfwd and jax.jacrev
    of the frozen step disagree there, and K5's plain version follows
    jacrev, not jacfwd;
  * K7 pgs_batched: against pallas_pgs_batched in interpret mode on the
    worm's frictional LCPs, rel 1e-10;
  * K1 at (nx, na) = (8, 2): against riccati_backward_pallas in interpret
    mode, rel 1e-10;
  * the wrappers' CPU dispatch and refusals.

Points: tests/test_torch_worm.py's worm states (in floor contact, moving
down and sliding), their classes from the port's classify_points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimblephysics_tpu.models import builders as jb
from nimblephysics_tpu.ops.contact import lcp_findex
from nimblephysics_tpu.ops.pallas_lcp import pallas_pgs_batched
from nimblephysics_tpu.ops.pallas_linearize import dyn_frozen_for_trace as j_dyn_frozen
from nimblephysics_tpu.ops.pallas_linearize import linearize_pallas_vjp
from nimblephysics_tpu.ops.pallas_riccati import riccati_backward_pallas

from nimblephysics_tpu_torch.models import builders as tb
from nimblephysics_tpu_torch.ops import frozen_contact as tf
from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched, pgs_batched_plain
from nimblephysics_tpu_torch.ops.cuda_linearize import (
    linear_position_update,
    linearize_vjp,
    linearize_vjp_plain,
)
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward

from test_torch_worm import worm_states
from torch_port_helpers import t64, to_port

N = 8          # worm points
CG = 12        # bench.py's planner PCG depth
CG_SHORT = 2   # below the clamping rows of the points


def close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.max(np.abs(b), initial=0.0)), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def pts():
    mj = jb.jump_worm(dt=0.001)
    mt = to_port(mj)
    q, v, u = worm_states(N, seed=23)
    x = np.concatenate([q, v], axis=1)
    cl, _ = tf.classify_points(mt, t64(x), mt.action_to_tau(t64(u)))
    cm, us = cl.cmask.numpy(), cl.us.numpy()
    return dict(mj=mj, mt=mt, x=x, u=u, cm=cm, us=us)


def jax_rows(pts, cg, mode):
    """The v' rows of the JAX frozen step's Jacobian by jacrev or jacfwd."""
    dyn = j_dyn_frozen(pts["mj"], cg_iters=cg)
    nq = pts["mj"].nq
    jac = jax.jacrev if mode == "rev" else jax.jacfwd
    f = jax.jit(jax.vmap(jac(lambda a, b, c, d: dyn(a, b, c, d)[nq:], argnums=(0, 1))))
    return f(*(jnp.asarray(pts[k]) for k in ("x", "u", "cm", "us")))


def port_vjp(pts, cg):
    cl = (t64(pts["cm"])[:, None], t64(pts["us"])[:, None])
    return linearize_vjp(pts["mt"], t64(pts["x"])[:, None], t64(pts["u"])[:, None], cl, cg)


def test_linearize_vjp_matches_jacrev_f64(pts):
    assert pts["cm"][:, :24].any() and (pts["us"] != 0).any()
    fx, fu = port_vjp(pts, CG)
    gx, gu = jax_rows(pts, CG, "rev")
    close(fx[:, 0, 4:], gx, 1e-9)
    close(fu[:, 0, 4:], gu, 1e-9)
    dt = float(pts["mt"].dt)
    top = np.concatenate([np.eye(4), dt * np.eye(4)], axis=1)
    np.testing.assert_array_equal(fx[:, 0, :4].numpy(), np.broadcast_to(top, (N, 4, 8)))
    np.testing.assert_array_equal(fu[:, 0, :4].numpy(), 0.0)


def test_linearize_vjp_follows_jacrev_below_the_clamping_rows(pts):
    """At PCG depth 2 with up to 9 rows clamping the truncated solve has not
    converged: forward mode with the implicit tangent (jacfwd, K4) and
    reverse mode with the transposed solve (jacrev, K5) give different
    Jacobians, and K5's plain version is the jacrev one."""
    assert int(pts["cm"].sum(-1).max()) > CG_SHORT
    fx, _ = port_vjp(pts, CG_SHORT)
    gx_rev, _ = jax_rows(pts, CG_SHORT, "rev")
    gx_fwd, _ = jax_rows(pts, CG_SHORT, "fwd")
    close(fx[:, 0, 4:], gx_rev, 1e-9)
    gap = float(np.abs(np.asarray(gx_fwd) - np.asarray(gx_rev)).max()
                / np.abs(np.asarray(gx_rev)).max())
    assert gap > 1e-6, gap


def test_linearize_vjp_matches_pallas_f32(pts):
    m32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        pts["mj"])
    f32 = {k: pts[k].astype(np.float32) for k in ("x", "u", "cm", "us")}
    fx_j, fu_j = jax.jit(lambda a, b, c, d: linearize_pallas_vjp(
        m32, a, b, (c, d), block_b=128, cg_iters=CG))(
            *(jnp.asarray(f32[k])[:, None] for k in ("x", "u", "cm", "us")))
    mt32 = to_port(pts["mj"], dtype=torch.float32)
    fx, fu = linearize_vjp(mt32, *(torch.as_tensor(f32[k])[:, None] for k in ("x", "u")),
                           tuple(torch.as_tensor(f32[k])[:, None] for k in ("cm", "us")), CG)
    close(fx, fx_j, 2e-4)
    close(fu, fu_j, 2e-4)


def test_pgs_batched_matches_pallas(pts):
    from nimblephysics_tpu_torch.ops import contact as tc
    from nimblephysics_tpu_torch.ops import dynamics as td
    from nimblephysics_tpu_torch.ops.collide import detect_contacts

    mt = pts["mt"]
    x, u = t64(pts["x"]), t64(pts["u"])
    q, v = x[:, :4], x[:, 4:]
    kin = td.forward_kinematics(mt, q)
    v_star = v + mt.dt * td.aba(mt, q, v, mt.action_to_tau(u), kin=kin)
    _, A, b, lo, hi, fs, _ = tc.build_constraint_system(
        mt, q, v_star, kin, detect_contacts(mt, kin.T_wb))
    x0 = 0.01 * t64(np.random.default_rng(3).standard_normal(b.shape))   # a warm start
    findex = lcp_findex(pts["mj"])
    want = pallas_pgs_batched(*(jnp.asarray(t.numpy()) for t in (A, b, lo, hi, fs, x0)),
                              findex, 60, block_b=16)
    got = pgs_batched(A, b, lo, hi, fs, x0, findex, 60)
    close(got, want, 1e-10)
    close(pgs_batched_plain(A, b, lo, hi, fs, x0, findex, 60), want, 1e-10)
    assert float(got.abs().max()) > 1e-3


def test_riccati_8_2_matches_pallas():
    """K1's plain version at the worm's (nx, na) = (8, 2)."""
    nx, na, T, B = 8, 2, 5, 3
    rng = np.random.default_rng(4)
    G = rng.standard_normal((B, T, nx, nx))
    Ga = rng.standard_normal((B, T, na, na))
    Gx = rng.standard_normal((B, nx, nx))
    args = (0.1 * rng.standard_normal((B, T, nx, nx)) + np.eye(nx),
            0.3 * rng.standard_normal((B, T, nx, na)), rng.standard_normal((B, T, nx)),
            rng.standard_normal((B, T, na)),
            np.einsum("btij,btkj->btik", G, G) / nx + 0.1 * np.eye(nx),
            np.einsum("btij,btkj->btik", Ga, Ga) / na + 0.5 * np.eye(na),
            0.1 * rng.standard_normal((B, T, na, nx)), rng.standard_normal((B, nx)),
            np.einsum("bij,bkj->bik", Gx, Gx) / nx + 0.1 * np.eye(nx),
            np.abs(rng.standard_normal(B)) * 0.1 + 1e-3)
    want = riccati_backward_pallas(*(jnp.asarray(a) for a in args), block_b=128)
    got = riccati_backward(*(t64(a) for a in args))
    for a, b in zip(got[:3], want[:3]):
        close(a, b, 1e-10)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_worm_wrappers_dispatch_and_refuse(pts):
    mt = pts["mt"]
    assert linear_position_update(mt)
    cl = (t64(pts["cm"])[:, None], t64(pts["us"])[:, None])
    args = (mt, t64(pts["x"])[:, None], t64(pts["u"])[:, None], cl, CG)
    for a, b in zip(linearize_vjp(*args), linearize_vjp_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        linearize_vjp(mt, t64(pts["x"])[:, None, :6].contiguous(), t64(pts["u"])[:, None], cl, CG)
    A = torch.eye(28, dtype=torch.float64).expand(2, 28, 28)
    z = torch.zeros(2, 28, dtype=torch.float64)
    with pytest.raises(ValueError, match="findex"):
        pgs_batched(A, z, z, z, z, z, (-1,) * 27, 60)
    with pytest.raises(RuntimeError, match="forward-only"):
        pgs_batched(A, z.clone().requires_grad_(True), z, z, z, z, (-1,) * 28, 60)
    # the builder's worm takes the same path
    assert linear_position_update(tb.jump_worm(dtype=torch.float64, device="cpu"))
