"""Articulated-body dynamics: forward kinematics, velocity kinematics, ABA
forward dynamics, CRBA mass matrix and RNEA inverse dynamics.

PyTorch counterpart of ``nimblephysics_tpu/ops/dynamics.py``. Topology is
static Python data, so the loops over bodies unroll into straight-line
tensor code; q, v and tau carry leading batch dimensions, and every output
keeps them. ``qdd``, ``tau`` and the mass matrix are built by
concatenation over the static dof layout, as in the reference.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import joints as J
from nimblephysics_tpu_torch.ops import lie, linalg_small
from nimblephysics_tpu_torch.ops.lie import Transform, _matvec
from nimblephysics_tpu_torch.ops.spatial import spatial_inertia


class Kinematics(NamedTuple):
    T_wb: List[Transform]        # body -> world
    T_pc: List[Transform]        # child body -> parent body
    S: List[torch.Tensor]        # (6, ndof) child-frame motion subspace


class VelKinematics(NamedTuple):
    V: List[torch.Tensor]        # (..., 6) body-frame spatial velocity
    c: List[torch.Tensor]        # (..., 6) velocity-product bias


def _joint_frames(model: Model, i: int):
    return (Transform(model.T_pj.R[i], model.T_pj.p[i]),
            Transform(model.T_cj.R[i], model.T_cj.p[i]))


def forward_kinematics(model: Model, q: torch.Tensor) -> Kinematics:
    T_wb, T_pc, S = [], [], []
    for i, jt in enumerate(model.joint_types):
        qi = q[..., model.joint_slice(i)]
        T_pj, T_cj = _joint_frames(model, i)
        Q = J.joint_transform(jt, qi, model.axes[i])
        Ti = T_pj.compose(Q).compose(T_cj.inverse())
        T_pc.append(Ti)
        S.append(J.child_subspace(jt, qi, model.axes[i], T_cj))
        p = model.parents[i]
        T_wb.append(Ti if p < 0 else T_wb[p].compose(Ti))
    return Kinematics(T_wb=T_wb, T_pc=T_pc, S=S)


def velocity_kinematics(
    model: Model, kin: Kinematics, q: torch.Tensor, v: torch.Tensor
) -> VelKinematics:
    V, c = [], []
    zero6 = q.new_zeros(q.shape[:-1] + (6,))
    for i, jt in enumerate(model.joint_types):
        sl = model.joint_slice(i)
        _, T_cj = _joint_frames(model, i)
        _, cJ = J.child_subspace_and_rate(jt, q[..., sl], v[..., sl],
                                          model.axes[i], T_cj)
        vJ = _matvec(kin.S[i], v[..., sl])
        p = model.parents[i]
        V_par = zero6 if p < 0 else lie.Ad_inv_apply(kin.T_pc[i], V[p])
        Vi = V_par + vJ
        V.append(Vi)
        c.append(cJ + lie.ad_motion(Vi, vJ))
    return VelKinematics(V=V, c=c)


def joint_forces(model: Model, q, v, tau) -> torch.Tensor:
    """Commanded tau plus the implicit spring (at q + dt v) and damping."""
    spring = -model.stiffness * (q - model.rest_pos + v * model.dt)
    damp = -model.damping * v
    return tau + spring + damp


def _body_inertias(model: Model) -> torch.Tensor:
    return spatial_inertia(model.mass, model.com, model.moment)


def _gravity_accel(model: Model, q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q.new_zeros(3), -model.gravity.to(q.dtype)])


def aba(
    model: Model,
    q: torch.Tensor,
    v: torch.Tensor,
    tau: torch.Tensor,
    f_ext: Optional[List[torch.Tensor]] = None,
    include_spring_damper: bool = True,
    kin: Optional[Kinematics] = None,
) -> torch.Tensor:
    """Articulated Body Algorithm: generalized accelerations (..., nq)."""
    nb = model.num_bodies
    if kin is None:
        kin = forward_kinematics(model, q)
    vel = velocity_kinematics(model, kin, q, v)
    tau_eff = joint_forces(model, q, v, tau) if include_spring_damper else tau
    I_body = _body_inertias(model)

    IA, pA = [None] * nb, [None] * nb
    for i in range(nb):
        IA[i] = I_body[i]
        bias = lie.ad_dual(vel.V[i], _matvec(I_body[i], vel.V[i]))
        if f_ext is not None and f_ext[i] is not None:
            bias = bias - f_ext[i]
        pA[i] = bias

    U, Dinv, u = [None] * nb, [None] * nb, [None] * nb
    for i in reversed(range(nb)):
        Si = kin.S[i]
        if Si.shape[1] > 0:
            U[i] = IA[i] @ Si                                  # (..., 6, nd)
            D = Si.T @ U[i]                                    # (..., nd, nd)
            Dinv[i] = linalg_small.inv_spd(D)
            u[i] = tau_eff[..., model.joint_slice(i)] - _matvec(Si.T, pA[i])
            Ia = IA[i] - U[i] @ Dinv[i] @ U[i].transpose(-1, -2)
            pa = (pA[i] + _matvec(Ia, vel.c[i])
                  + _matvec(U[i], _matvec(Dinv[i], u[i])))
        else:
            Ia = IA[i]
            pa = pA[i] + _matvec(Ia, vel.c[i])
        p = model.parents[i]
        if p >= 0:
            X = lie.Ad_inv(kin.T_pc[i])                        # parent -> child
            Xt = X.transpose(-1, -2)
            IA[p] = IA[p] + Xt @ Ia @ X
            pA[p] = pA[p] + _matvec(Xt, pa)

    g_accel = _gravity_accel(model, q)
    a = [None] * nb
    qdd_parts = []
    for i in range(nb):
        p = model.parents[i]
        a_par = (lie.Ad_inv_apply(kin.T_wb[i], g_accel) if p < 0
                 else lie.Ad_inv_apply(kin.T_pc[i], a[p]))
        a_prime = a_par + vel.c[i]
        Si = kin.S[i]
        if Si.shape[1] > 0:
            qdd_i = _matvec(Dinv[i],
                            u[i] - _matvec(U[i].transpose(-1, -2), a_prime))
            qdd_parts.append(qdd_i)
            a[i] = a_prime + _matvec(Si, qdd_i)
        else:
            a[i] = a_prime
    return torch.cat(qdd_parts, dim=-1) if qdd_parts else torch.zeros_like(v)


def rnea(
    model: Model,
    q: torch.Tensor,
    v: torch.Tensor,
    qdd: torch.Tensor,
    f_ext: Optional[List[torch.Tensor]] = None,
    gravity: bool = True,
) -> torch.Tensor:
    """Recursive Newton-Euler inverse dynamics: tau(q, v, qdd), (..., nq)."""
    nb = model.num_bodies
    kin = forward_kinematics(model, q)
    vel = velocity_kinematics(model, kin, q, v)
    I_body = _body_inertias(model)
    g_accel = _gravity_accel(model, q) if gravity else q.new_zeros(6)

    a = [None] * nb
    for i in range(nb):
        p = model.parents[i]
        a_par = (lie.Ad_inv_apply(kin.T_wb[i], g_accel) if p < 0
                 else lie.Ad_inv_apply(kin.T_pc[i], a[p]))
        Si = kin.S[i]
        a[i] = a_par + vel.c[i]
        if Si.shape[1] > 0:
            a[i] = a[i] + _matvec(Si, qdd[..., model.joint_slice(i)])

    f = [None] * nb
    for i in range(nb):
        f[i] = _matvec(I_body[i], a[i]) + lie.ad_dual(
            vel.V[i], _matvec(I_body[i], vel.V[i]))
        if f_ext is not None and f_ext[i] is not None:
            f[i] = f[i] - f_ext[i]

    tau_parts = [None] * nb
    for i in reversed(range(nb)):
        Si = kin.S[i]
        if Si.shape[1] > 0:
            tau_parts[i] = _matvec(Si.T, f[i])
        p = model.parents[i]
        if p >= 0:
            f[p] = f[p] + lie.Ad_dual_apply(kin.T_pc[i], f[i])
    parts = [t for t in tau_parts if t is not None]
    return torch.cat(parts, dim=-1) if parts else torch.zeros_like(v)


def mass_matrix(
    model: Model, q: torch.Tensor, kin: Optional[Kinematics] = None
) -> torch.Tensor:
    """Composite Rigid Body Algorithm: M(q), (..., nq, nq)."""
    nb, nq = model.num_bodies, model.nq
    batch = q.shape[:-1]
    if kin is None:
        kin = forward_kinematics(model, q)
    I_body = _body_inertias(model)
    Ic = [I_body[i] for i in range(nb)]
    for i in reversed(range(nb)):
        p = model.parents[i]
        if p >= 0:
            X = lie.Ad_inv(kin.T_pc[i])
            Ic[p] = Ic[p] + X.transpose(-1, -2) @ Ic[i] @ X
    blocks = {}
    for i in range(nb):
        Si = kin.S[i]
        if Si.shape[1] == 0:
            continue
        F = Ic[i] @ Si                                         # (..., 6, nd)
        blocks[(i, i)] = Si.T @ F
        j = i
        while model.parents[j] >= 0:
            # move F to the parent frame, column by column
            T = kin.T_pc[j]
            T_col = Transform(T.R.unsqueeze(-3), T.p.unsqueeze(-2))
            F = lie.Ad_dual_apply(T_col, F.transpose(-1, -2)).transpose(-1, -2)
            j = model.parents[j]
            Sj = kin.S[j]
            if Sj.shape[1] > 0:
                blk = Sj.T @ F                                 # (..., ndj, ndi)
                blocks[(j, i)] = blk
                blocks[(i, j)] = blk.transpose(-1, -2)
    ndofs = [kin.S[i].shape[1] for i in range(nb)]
    rows = []
    for a in range(nb):
        if ndofs[a] == 0:
            continue
        row = []
        for b in range(nb):
            if ndofs[b] == 0:
                continue
            blk = blocks.get((a, b))
            if blk is None:
                blk = q.new_zeros(batch + (ndofs[a], ndofs[b]))
            row.append(blk.expand(batch + blk.shape[-2:]))
        rows.append(torch.cat(row, dim=-1))
    if not rows:
        return q.new_zeros(batch + (nq, nq))
    return torch.cat(rows, dim=-2)
