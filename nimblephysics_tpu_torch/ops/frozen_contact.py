"""Frozen-active-set contact dynamics: the contact-MPC fast path.

PyTorch counterpart of ``nimblephysics_tpu/ops/frozen_contact.py``. Across
a replan the LCP's active set barely changes, so with the per-step class
masks frozen (clamping c, upper u with signed scale s) the boxed LCP
collapses to one linear solve,

    x = R x_C,  (A[C,:] R) x_C = b_C,  v' = v* + M^-1 J^T x,

a step that is smooth in (q, v, tau). The mode sequence comes from one
full-LCP rollout per replan (``rollout_classes``, or its kernel form
``ops/cuda_rollout.rollout_classes``). States carry leading batch
dimensions. ``planner_reduce_contacts`` is ROADMAP queue A, M5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.ops.collide import detect_contacts, total_slots
from nimblephysics_tpu_torch.ops.contact import (
    build_constraint_system,
    contact_step,
    lcp_dim,
    lcp_findex,
)
from nimblephysics_tpu_torch.ops.lcp import classify_lane, direct_boxed_solve_lane
from nimblephysics_tpu_torch.simulation.step import integrate_positions


class FrozenClasses(NamedTuple):
    """Per-step LCP class masks (leading axes broadcast over batch/time)."""

    cmask: torch.Tensor   # (..., m) 1.0 where the row is CLAMPING
    us: torch.Tensor      # (..., m) sign * fscale where UPPER, else 0


def gov_matrix(model: Model) -> np.ndarray:
    """(m, m) constant: gov[i, findex_i] = 1 for coupled rows."""
    fi = lcp_findex(model)
    gov = np.zeros((len(fi), len(fi)))
    for i, f in enumerate(fi):
        if f >= 0:
            gov[i, f] = 1.0
    return gov


def classes_from_info(info) -> FrozenClasses:
    """FrozenClasses of a full LCP solve's ContactSolveInfo."""
    dtype = info.impulses.dtype
    return FrozenClasses(cmask=info.clamping.to(dtype),
                         us=info.upper.to(dtype) * info.upper_sign)


def _pcg(Qf, reg, diagM, bb, n_cg: int):
    """Jacobi-preconditioned CG on (Qf^T Qf + reg I) x = bb from x = 0,
    n_cg iterations."""
    tiny = 1e-30

    def matvec(p):
        return (Qf.transpose(-1, -2) @ (Qf @ p[..., None]))[..., 0] + reg * p

    x = torch.zeros_like(bb)
    r = bb
    z = r / diagM
    p = z
    rz = (r * z).sum(-1)
    for _ in range(n_cg):
        Ap = matvec(p)
        alpha = rz / ((p * Ap).sum(-1) + tiny)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        z = r / diagM
        rz_new = (r * z).sum(-1)
        p = z + (rz_new / (rz + tiny))[..., None] * p
        rz = rz_new
    return x


class _FrozenPCG(torch.autograd.Function):
    """x = PCG(Qf^T Qf + reg I, bvec) with the derivatives of a linear
    solve, as ``lax.custom_linear_solve(..., symmetric=True)`` gives them to
    the JAX package. Forward mode: dx = PCG(dbvec - (dQf^T Qf x + Qf^T dQf x
    + dreg x)), run with the same iteration count and the primal Jacobi
    preconditioner. Reverse mode, its transpose: the same truncated PCG on
    the cotangent, lam = PCG(xbar), then bvec_bar = lam and the closure
    cotangent -(d(Qf^T Qf p + reg p)/d(Qf, reg) at p = x)^T lam; diagM is
    the solver's, not the problem's, and gets none. Differentiating through
    the CG iterations would give the derivative of the truncated iteration
    instead, another number in f32 and at a small n_cg."""

    generate_vmap_rule = True

    @staticmethod
    def forward(Qf, reg, diagM, bvec, n_cg):
        return _pcg(Qf, reg, diagM, bvec, n_cg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        Qf, reg, diagM, _, n_cg = inputs
        ctx.n_cg = n_cg
        ctx.save_for_forward(Qf, reg, diagM, output)
        ctx.save_for_backward(Qf, reg, diagM, output)

    @staticmethod
    def jvp(ctx, dQf, dreg, _ddiagM, dbvec, _dn):
        Qf, reg, diagM, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if dbvec is None else dbvec
        if dQf is not None:
            Qx = (Qf @ x[..., None])[..., 0]
            dQx = (dQf @ x[..., None])[..., 0]
            rhs = rhs - ((dQf.transpose(-1, -2) @ Qx[..., None])[..., 0]
                         + (Qf.transpose(-1, -2) @ dQx[..., None])[..., 0])
        if dreg is not None:
            rhs = rhs - dreg * x
        return _pcg(Qf, reg, diagM, rhs, ctx.n_cg)

    @staticmethod
    def backward(ctx, grad):
        Qf, reg, diagM, x = ctx.saved_tensors
        lam = _pcg(Qf, reg, diagM, grad, ctx.n_cg)
        Qx = (Qf @ x[..., None])[..., 0]
        Ql = (Qf @ lam[..., None])[..., 0]
        gQf = -(Qx[..., :, None] * lam[..., None, :] + Ql[..., :, None] * x[..., None, :])
        greg = -(lam * x).sum(-1, keepdim=True)
        return gQf, greg, None, lam, None


def solve_frozen(A, b, classes: FrozenClasses, gov: torch.Tensor,
                 cg_iters: Optional[int] = None) -> torch.Tensor:
    """Impulses on a frozen class structure: R = (I + diag(us) gov)
    restricted to the clamping columns, the clamping subsystem solved by
    regularized normal equations (x minimizes |Qf x - rhs|^2 + reg |x|^2)
    with Jacobi-preconditioned CG, ``cg_iters`` iterations (None: m + 6)."""
    m = b.shape[-1]
    dtype = b.dtype
    eye = torch.eye(m, dtype=dtype, device=b.device)
    cmask = classes.cmask
    R = (eye + classes.us[..., :, None] * gov) * cmask[..., None, :]
    AR = A @ R
    Qf = cmask[..., :, None] * AR * cmask[..., None, :] + eye * (1.0 - cmask)[..., :, None]
    rhs = cmask * b
    eps = 1e-10 if dtype == torch.float64 else 1e-5
    qmax = torch.amax(Qf.abs(), dim=(-2, -1), keepdim=True)
    qscale = torch.maximum(qmax, torch.ones_like(qmax))
    reg = (eps * qscale * qscale)[..., 0]                       # (..., 1)
    QfT = Qf.transpose(-1, -2)
    diagM = (Qf * Qf).sum(-2) + reg
    n_cg = (m + 6) if cg_iters is None else int(cg_iters)
    bvec = (QfT @ rhs[..., None])[..., 0]
    x_C = _FrozenPCG.apply(Qf, reg, diagM, bvec, n_cg)
    return (R @ (cmask * x_C)[..., None])[..., 0]


def frozen_contact_step(
    model: Model,
    state: State,
    tau: torch.Tensor,
    classes: FrozenClasses,
    gov: Optional[torch.Tensor] = None,
    servo_cmd: Optional[torch.Tensor] = None,
    cg_iters: Optional[int] = None,
) -> State:
    """One smooth constrained step on a frozen mode (planning dynamics)."""
    q, v = state.q, state.v
    kin0 = dyn.forward_kinematics(model, q)
    qdd = dyn.aba(model, q, v, tau, kin=kin0)
    v_star = v + model.dt * qdd
    q_next = integrate_positions(model, q, v)
    if lcp_dim(model) == 0:
        return State(q_next, v_star)
    contacts = detect_contacts(model, kin0.T_wb)
    J, A, b, lo, hi, fscale, Minv_Jt = build_constraint_system(
        model, q, v_star, kin0, contacts, servo_cmd, planner=True)
    if gov is None:
        gov = torch.as_tensor(gov_matrix(model), dtype=q.dtype, device=q.device)
    x = solve_frozen(A, b, classes, gov, cg_iters=cg_iters)
    return State(q_next, v_star + (Minv_Jt @ x[..., None])[..., 0])


def classify_points(model: Model, xs_flat: torch.Tensor, taus: torch.Tensor,
                    x_warm: Optional[torch.Tensor] = None, kernels: bool = True):
    """Pointwise mode classification: the full boxed LCP solved
    independently at every trajectory point (any leading batch axes), from
    ``x_warm`` (zeros when None); returns (FrozenClasses, impulses). A
    model with contact slots solves by PGS, on CUDA tensors through the
    kernel K7 when ``kernels``."""
    _, info = contact_step(model, State.from_flat(xs_flat), taus, x_warm=x_warm,
                           return_info=True, kernels=kernels)
    return classes_from_info(info), info.impulses


def fused_class_rollout_ok(model: Model) -> bool:
    """True when the full constrained step (non-planner assembly, direct
    boxed LCP in its lane form, classify) runs inside the class-rollout
    kernel: no contact slots, no loop closures, no servos, linear position
    integration, and the pivot-free mass solve's size cap."""
    return (total_slots(model) == 0 and not model.loops and not model.servo_dofs
            and model.nq <= 40
            and all(t not in ("ball", "free") for t in model.joint_types))


def step_with_classes_for_trace(model: Model):
    """The full constrained step returning (x', cmask, us) with the
    lane-form solver and classification: the step the class-rollout kernel
    runs, for models passing ``fused_class_rollout_ok``."""
    findex = lcp_findex(model)

    def step_fn(x, u):
        s = State.from_flat(x)
        q, v = s.q, s.v
        tau = model.action_to_tau(u)
        kin0 = dyn.forward_kinematics(model, q)
        qdd = dyn.aba(model, q, v, tau, kin=kin0)
        v_star = v + model.dt * qdd
        contacts = detect_contacts(model, kin0.T_wb)
        J, A, b, lo, hi, fscale, Minv_Jt = build_constraint_system(
            model, q, v_star, kin0, contacts, None, planner=False, spd_solve=True)
        x_imp = direct_boxed_solve_lane(A, b, lo, hi)
        v_next = v_star + (Minv_Jt @ x_imp[..., None])[..., 0]
        q_next = integrate_positions(model, q, v)
        cl, up, sgn = classify_lane(x_imp, lo, hi, fscale, findex)
        return torch.cat([q_next, v_next], dim=-1), cl.to(x.dtype), up.to(x.dtype) * sgn

    return step_fn


def rollout_classes(model: Model, state0: State, actions: torch.Tensor):
    """Full-LCP rollout that records the per-step mode sequence, actions
    (..., T, na). Returns (final state, trajectory (..., T, nq) States,
    FrozenClasses (..., T, m), impulses (..., T, m))."""
    s, x_prev = state0, None
    qs, vs, cms, uss, imps = [], [], [], [], []
    for t in range(actions.shape[-2]):
        s, info = contact_step(model, s, model.action_to_tau(actions[..., t, :]),
                               x_warm=x_prev, return_info=True)
        x_prev = info.impulses
        cl = classes_from_info(info)
        qs.append(s.q)
        vs.append(s.v)
        cms.append(cl.cmask)
        uss.append(cl.us)
        imps.append(info.impulses)
    traj = State(q=torch.stack(qs, dim=-2), v=torch.stack(vs, dim=-2))
    return (s, traj, FrozenClasses(torch.stack(cms, dim=-2), torch.stack(uss, dim=-2)),
            torch.stack(imps, dim=-2))
