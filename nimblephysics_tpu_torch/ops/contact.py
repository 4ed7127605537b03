"""The constrained timestep: collision, boxed LCP, impulse application.

PyTorch counterpart of ``nimblephysics_tpu/ops/contact.py``:

    qdd  = ABA(q, v, tau)                         unconstrained forward dynamics
    v*   = v + dt qdd                             pre-constraint velocity
    x    = BoxedLCP(J M^-1 J^T + cfm I, -J v* + bounce)   impulses
    v'   = v* + M^-1 J^T x
    q'   = integrate(q, v)                        pre-step velocity

States carry leading batch dimensions. The LCP rows are the contact rows
(a normal and two friction rows per contact slot, the friction rows
coupled to their normal impulse), the joint-limit rows and the Coulomb
joint-friction rows. ``contact_step`` solves a model with contact slots by
projected Gauss-Seidel (``method="gs"``, 60 sweeps, the CUDA kernel K7 on
CUDA tensors) and a limits-only model by the direct active-set solve,
both differentiated by the LCP's implicit rule (``ops/lcp.boxed_lcp``);
``accuracy="staged"`` and ``"hyper"`` take the staged cascade. Servo, mimic
and loop-closure rows are ROADMAP queue A, M4 (d).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.ops import lcp as lcp_mod
from nimblephysics_tpu_torch.ops.collide import ContactSlots, detect_contacts, total_slots
from nimblephysics_tpu_torch.ops.linalg_small import solve_spd

# Reference constants: ContactConstraint.cpp:46-48, DART_RESTITUTION_*
CFM = 1e-5
RESTITUTION_THRESHOLD = 1e-3
BOUNCING_VELOCITY_THRESHOLD = 1e-1
MAX_BOUNCING_VELOCITY = 1e2
_BIG = lcp_mod._BIG


# Model -> (leaf versions, (limited dofs, Coulomb dofs)); weak, like the
# packed model of ops/device_step.py.
_ROW_DOFS: "weakref.WeakKeyDictionary[Model, tuple]" = weakref.WeakKeyDictionary()


def _row_dofs(model: Model):
    """The dofs with limit rows and with Coulomb rows: static topology read
    from the leaves' values, once per version of those leaves (with
    torch.func's dispatch off, so that a first read inside a transform, as
    in jacfwd of ``step``, sees the plain leaves)."""
    leaves = (model.q_lower, model.q_upper, model.coulomb_friction)
    key = tuple((t.data_ptr(), t._version) for t in leaves)
    hit = _ROW_DOFS.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch._C._DisableFuncTorch():
        lo, hi, cf = (t.detach().cpu().numpy() for t in leaves)
    rows = (tuple(int(d) for d in range(model.nq) if np.isfinite(lo[d]) or np.isfinite(hi[d])),
            tuple(int(d) for d in range(model.nq) if cf[d] > 0.0))
    _ROW_DOFS[model] = (key, rows)
    return rows


def limited_dofs(model: Model) -> Tuple[int, ...]:
    """Dofs with any finite position limit."""
    return _row_dofs(model)[0]


def coulomb_dofs(model: Model) -> Tuple[int, ...]:
    """Dofs with static Coulomb joint friction."""
    return _row_dofs(model)[1]


def loop_rows(model: Model) -> int:
    """LCP rows of loop-closure constraints: 3 per ball, 6 per weld."""
    return sum(3 if kind == "ball" else 6 for kind, _, _ in model.loops)


def lcp_dim(model: Model) -> int:
    """Rows of the padded boxed LCP: 3 per contact slot, 2 per limited dof,
    1 per Coulomb dof (and the unported servo, mimic and loop rows)."""
    return (3 * total_slots(model) + 2 * len(limited_dofs(model))
            + len(coulomb_dofs(model)) + len(model.servo_dofs) + len(model.mimic)
            + loop_rows(model))


def lcp_findex(model: Model) -> Tuple[int, ...]:
    """Static friction-coupling index per LCP row (-1: uncoupled)."""
    fi = []
    for k in range(total_slots(model)):
        fi.extend([-1, 3 * k, 3 * k])
    fi.extend([-1] * (2 * len(limited_dofs(model))))
    fi.extend([-1] * len(coulomb_dofs(model)))
    fi.extend([-1] * (len(model.servo_dofs) + len(model.mimic)))
    fi.extend([-1] * loop_rows(model))
    return tuple(fi)


def _tangent_basis(n: torch.Tensor):
    """ODE-style tangent basis (the reference's
    getTangentBasisMatrixODE): the first friction direction is z x n,
    falling back to x x n, branch-free; n (..., 3) -> (t1, t2)."""
    z = torch.zeros_like(n) + torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    x = torch.zeros_like(n) + torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    t_z = torch.linalg.cross(z, n)
    t_x = torch.linalg.cross(x, n)
    use_z = ((t_z * t_z).sum(-1) > 1e-12)[..., None]
    t = torch.where(use_z, t_z, t_x)
    t = t / torch.sqrt(torch.clamp((t * t).sum(-1, keepdim=True), min=1e-18))
    return t, torch.linalg.cross(n, t)


def _contact_rows(model: Model, q: torch.Tensor, v_star: torch.Tensor, kin,
                  contacts: ContactSlots, planner: bool):
    """J (..., 3K, nq), b, lo, hi, fscale (..., 3K) of the contact slots:
    per slot the normal row and two friction rows. The full form gates
    each slot on its penetration and adds the restitution bounce; the
    planner form keeps every row (the frozen classes decide activity)."""
    nq = model.nq
    K = len(contacts.body_a)
    batch = q.shape[:-1]
    Jw = dyn.world_jacobian(model, kin)                         # (..., nb, 6, nq)
    zero6 = q.new_zeros(batch + (6, nq))

    def body_jac(bodies):
        return torch.stack([Jw[..., b, :, :] if b >= 0 else zero6 for b in bodies], dim=-3)

    p = contacts.point                                           # (..., K, 3)
    Jp = dyn._point_rows(body_jac(contacts.body_a), p) - dyn._point_rows(
        body_jac(contacts.body_b), p)                            # (..., K, 3, nq)
    n = contacts.normal
    t1, t2 = _tangent_basis(n)
    dirs = torch.stack([n, t1, t2], dim=-2)                      # (..., K, 3, 3)
    if planner:
        act = q.new_ones(batch + (K,))
    else:
        act = contacts.active.to(q.dtype)
    rows_c = act[..., None, None] * (dirs @ Jp)                  # (..., K, 3, nq)
    rel_v = (rows_c @ v_star[..., None, :, None])[..., 0]        # (..., K, 3)
    neg_vn = -rel_v[..., 0]
    e = contacts.restitution
    restitution_vel = torch.where(e > RESTITUTION_THRESHOLD, neg_vn * e,
                                  torch.zeros_like(neg_vn))
    bounce = torch.where(restitution_vel > BOUNCING_VELOCITY_THRESHOLD,
                         torch.clamp(restitution_vel, max=MAX_BOUNCING_VELOCITY),
                         torch.zeros_like(restitution_vel))
    if planner:
        bounce = torch.zeros_like(bounce)
    b_c = torch.stack([act * (neg_vn + bounce), -act * rel_v[..., 1], -act * rel_v[..., 2]],
                      dim=-1)
    zero_k = torch.zeros_like(act)
    hi_c = torch.stack([act * _BIG, zero_k, zero_k], dim=-1)
    mu = contacts.friction * act
    fs_c = torch.stack([zero_k, mu, mu], dim=-1)
    return (rows_c.reshape(batch + (3 * K, nq)), b_c.reshape(batch + (3 * K,)),
            q.new_zeros(batch + (3 * K,)), hi_c.reshape(batch + (3 * K,)),
            fs_c.reshape(batch + (3 * K,)))


class ContactSolveInfo(NamedTuple):
    """Post-step constraint diagnostics: the impulses, the constraint
    Jacobian, the pre-constraint velocity and the class masks of the
    solution (the reference's CLAMPING / UPPER_BOUND classification)."""

    impulses: torch.Tensor       # (..., m) LCP solution
    contacts: ContactSlots
    J: torch.Tensor              # (..., m, nq) constraint Jacobian
    v_star: torch.Tensor         # (..., nq) pre-constraint velocity
    clamping: torch.Tensor       # (..., m) bool: constraint holds with equality
    upper: torch.Tensor          # (..., m) bool: friction riding the cone surface
    upper_sign: torch.Tensor     # (..., m) sign(x_i) fscale_i
    residual: torch.Tensor       # (...,) boxed-complementarity violation


def _no_unported_rows(model: Model) -> None:
    if model.servo_dofs or model.mimic or model.loops:
        raise NotImplementedError(
            "servo, mimic and loop-closure rows are not ported yet (ROADMAP "
            "queue A, M4)")


class _MassSolve(torch.autograd.Function):
    """X = M^-1 B by LU with partial pivoting (``torch.linalg.solve``, as
    ``jnp.linalg.solve``), with the derivatives of a linear solve spelled
    through M^-1: dX = M^-1 (dB - dM X), and the transpose. torch's own
    forward derivatives of ``linalg.solve`` and ``linalg.lu_solve`` mix the
    points of a vmap (``vmap(jacfwd)`` of the full step gave another point's
    tangent); those of ``linalg.inv`` and matmul do not."""

    generate_vmap_rule = True

    @staticmethod
    def forward(M, B):
        return torch.linalg.solve(M, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0], output)
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def jvp(ctx, dM, dB):
        M, X = ctx.saved_tensors
        rhs = torch.zeros_like(X) if dB is None else dB
        if dM is not None:
            rhs = rhs - dM @ X
        return torch.linalg.inv(M) @ rhs

    @staticmethod
    def backward(ctx, g):
        M, X = ctx.saved_tensors
        gB = torch.linalg.inv(M).transpose(-1, -2) @ g
        return -gB @ X.transpose(-1, -2), gB


def build_constraint_system(
    model: Model,
    q: torch.Tensor,
    v_star: torch.Tensor,
    kin,
    contacts: ContactSlots,
    servo_cmd: Optional[torch.Tensor] = None,
    planner: bool = False,
    spd_solve: Optional[bool] = None,
):
    """J, A, b, lo, hi, fscale, M^-1 J^T of the padded boxed LCP, each with
    the leading batch dimensions of q.

    ``planner=True`` builds the smooth planning variant of the frozen-class
    path (ops/frozen_contact.py): every row is gated on and the restitution
    bounce is dropped (the frozen class masks decide row activity), and the
    mass solve is the pivot-free SPD solve. The contact rows come first (a
    normal and two friction rows per slot), then the limit rows (all lower
    rows, then all upper rows), then the Coulomb rows."""
    _no_unported_rows(model)
    nq = model.nq
    dtype, device = q.dtype, q.device
    batch = q.shape[:-1]
    Ld = limited_dofs(model)
    Cd = coulomb_dofs(model)
    zeros = q.new_zeros(batch + (0,))
    J = q.new_zeros(batch + (0, nq))
    b, lo, hi, fscale = zeros, zeros, zeros, zeros
    if len(contacts.body_a):
        J, b, lo, hi, fscale = _contact_rows(model, q, v_star, kin, contacts, planner)
    if Ld:
        # lower limit active when q <= lo (impulse >= 0 on +e_d); upper when
        # q >= hi (row -e_d with impulse >= 0)
        E = torch.eye(nq, dtype=dtype, device=device)[list(Ld)]          # (L, nq)
        v_star_L = (E @ v_star[..., None])[..., 0]
        if planner:
            lo_act = q.new_ones(batch + (len(Ld),))
            hi_act = q.new_ones(batch + (len(Ld),))
        else:
            q_L = (E @ q[..., None])[..., 0]
            d_idx = list(Ld)
            lo_act = ((q_L - model.q_lower[d_idx]) <= 0.0).to(dtype)
            hi_act = ((q_L - model.q_upper[d_idx]) >= 0.0).to(dtype)
        J_lim = torch.cat([lo_act[..., None] * E, -hi_act[..., None] * E], dim=-2)
        b_lim = torch.cat([-lo_act * v_star_L, hi_act * v_star_L], dim=-1)
        hi_lim = torch.cat([lo_act, hi_act], dim=-1) * _BIG
        J = torch.cat([J, J_lim], dim=-2)
        b = torch.cat([b, b_lim], dim=-1)
        lo = torch.cat([lo, q.new_zeros(batch + (2 * len(Ld),))], dim=-1)
        hi = torch.cat([hi, hi_lim], dim=-1)
        fscale = torch.cat([fscale, q.new_zeros(batch + (2 * len(Ld),))], dim=-1)
    if Cd:
        # boxed impulse |x| <= mu_c dt resisting the dof velocity
        Ec = torch.eye(nq, dtype=dtype, device=device)[list(Cd)]
        f_imp = (model.coulomb_friction[list(Cd)] * model.dt).expand(batch + (len(Cd),))
        J = torch.cat([J, Ec.expand(batch + Ec.shape)], dim=-2)
        b = torch.cat([b, -(Ec @ v_star[..., None])[..., 0]], dim=-1)
        lo = torch.cat([lo, -f_imp], dim=-1)
        hi = torch.cat([hi, f_imp], dim=-1)
        fscale = torch.cat([fscale, q.new_zeros(batch + (len(Cd),))], dim=-1)

    M = dyn.mass_matrix(model, q, kin=kin)
    if spd_solve is None:
        spd_solve = planner and nq <= 40
    Jt = J.transpose(-1, -2)
    Minv_Jt = solve_spd(M, Jt) if spd_solve else _MassSolve.apply(M, Jt)
    m_total = J.shape[-2]
    A = J @ Minv_Jt + CFM * torch.eye(m_total, dtype=dtype, device=device)
    return J, A, b, lo, hi, fscale, Minv_Jt


def contact_step(
    model: Model,
    state: State,
    tau: torch.Tensor,
    x_warm: Optional[torch.Tensor] = None,
    lcp_iters: Optional[int] = None,
    return_info: bool = False,
    servo_cmd: Optional[torch.Tensor] = None,
    accuracy: str = "standard",
    kernels: bool = True,
):
    """One constrained timestep. ``accuracy`` "standard": a model with
    contact slots takes projected Gauss-Seidel (``lcp_iters`` sweeps, 60 by
    default) from ``x_warm`` (zeros when None), through K7 on CUDA tensors
    when ``kernels``; a limit/Coulomb-only LCP takes the direct active-set
    solve (``lcp_iters`` rounds, 3 by default), for which ``x_warm`` is
    unused. "staged": the residual-gated cascade (``ops/lcp.staged_solve``,
    ``lcp_iters`` 60 by default), "hyper" the same at 2,500 sweeps, the
    reference's hyper-accurate setting; their PGS stages go through K7
    likewise."""
    if accuracy not in ("standard", "staged", "hyper"):
        raise ValueError(f"contact_step: unknown accuracy {accuracy!r}")
    q, v = state.q, state.v
    kin0 = dyn.forward_kinematics(model, q)
    qdd = dyn.aba(model, q, v, tau, kin=kin0)
    v_star = v + model.dt * qdd
    # imported here: simulation/step.py imports this module
    from nimblephysics_tpu_torch.simulation.step import integrate_positions

    m = lcp_dim(model)
    if m == 0:
        out = State(integrate_positions(model, q, v), v_star)
        return (out, None) if return_info else out
    if accuracy != "standard":
        method = "staged"
        if lcp_iters is None:
            lcp_iters = 2500 if accuracy == "hyper" else 60
    elif total_slots(model) > 0:
        method = "gs"
        lcp_iters = 60 if lcp_iters is None else lcp_iters
    else:
        method = "direct"
        lcp_iters = 3 if lcp_iters is None else lcp_iters
    contacts = detect_contacts(model, kin0.T_wb)
    J, A, b, lo, hi, fscale, Minv_Jt = build_constraint_system(
        model, q, v_star, kin0, contacts, servo_cmd)
    findex = lcp_findex(model)
    if x_warm is None:
        x_warm = torch.zeros_like(b)
    x = lcp_mod.boxed_lcp(A, b, lo, hi, fscale, x_warm, findex, lcp_iters, method,
                          kernels=kernels)
    v_next = v_star + (Minv_Jt @ x[..., None])[..., 0]
    out = State(integrate_positions(model, q, v), v_next)
    if not return_info:
        return out
    clamping, upper, s = lcp_mod._classify(x, lo, hi, fscale, findex)
    resid = lcp_mod.lcp_residual(A, x, b, lo, hi, fscale, findex)
    return out, ContactSolveInfo(
        impulses=x, contacts=contacts, J=J, v_star=v_star, clamping=clamping,
        upper=upper, upper_sign=s, residual=resid.detach())
