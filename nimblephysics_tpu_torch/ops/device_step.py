"""Pack a Model into the flat buffers of the device step (csrc/step.cuh).

Shared by the linearize (K3, K4) and rollout (K2, K6) kernels. The layout
is the one documented in ``csrc/step.cuh``: a reals buffer in the model's
dtype and an int32 buffer with the topology, both on the model's device;
a model with constraint rows (joint limits, Coulomb friction) appends one
real per row (its limit position or impulse bound) and, per row, its dof
and its kind.
"""

from __future__ import annotations

import weakref
from collections import Counter

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import joints as J
from nimblephysics_tpu_torch.ops.lie import Transform
from nimblephysics_tpu_torch.ops.spatial import spatial_inertia

JOINT_CODES = {"weld": 0, "revolute": 1, "prismatic": 2}
# csrc/step.cuh RowKind
ROW_LOWER, ROW_UPPER, ROW_COULOMB = 0, 1, 2


def check_model(model: Model) -> None:
    """Raise unless the device step covers this model's joints. Which
    (bodies, dofs, actions) shapes are built is NPTT_STEP_SHAPES in
    csrc/step.cuh; the launchers refuse any other."""
    bad = [t for t in model.joint_types if t not in JOINT_CODES]
    if bad:
        raise NotImplementedError(
            f"the device step covers weld/revolute/prismatic joints, not {bad}")
    if model.shapes or model.servo_dofs or model.mimic or model.loops:
        raise NotImplementedError(
            "the device step covers joint-limit and Coulomb rows only (ROADMAP "
            "queue A, M4: contact, servo, mimic and loop rows)")


def check_contact_model(name: str, model: Model) -> int:
    """The row count m of a model the constrained kernels (K2 with classes,
    K4, K6) take; raises for any other, so no caller drops silently to a
    plain version."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim
    from nimblephysics_tpu_torch.ops.frozen_contact import fused_class_rollout_ok

    m = lcp_dim(model)
    if m == 0 or not fused_class_rollout_ok(model):
        raise NotImplementedError(
            f"{name}: the constrained kernels take models with joint-limit or "
            "Coulomb rows that pass fused_class_rollout_ok (ROADMAP queue A, "
            "M4/M5 for contact)")
    check_model(model)
    return m


def constraint_rows(model: Model):
    """(dof, kind) of each LCP row in ops/contact.py's order: the lower
    limit rows, the upper limit rows, the Coulomb rows."""
    from nimblephysics_tpu_torch.ops.contact import coulomb_dofs, limited_dofs

    Ld = limited_dofs(model)
    return ([(d, ROW_LOWER) for d in Ld] + [(d, ROW_UPPER) for d in Ld]
            + [(d, ROW_COULOMB) for d in coulomb_dofs(model)])


# Model -> (leaf versions, (reals, ints)); weak, so a dropped Model frees
# its packed buffers.
_PACKED: "weakref.WeakKeyDictionary[Model, tuple]" = weakref.WeakKeyDictionary()


def pack_model(model: Model):
    """(reals, ints) for the device step. Packed once per Model, and again
    after any of its leaves was replaced or changed in place (for example
    ``model.mass[1] *= 1.1``): the key holds each leaf's storage and version
    counter."""
    key = tuple((t.data_ptr(), t._version) for t in model.leaves().values())
    hit = _PACKED.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    packed = _pack(model)
    _PACKED[model] = (key, packed)
    return packed


def _pack(model: Model):
    check_model(model)
    nb = model.num_bodies
    per_body = []
    for i, jt in enumerate(model.joint_types):
        T_cj = Transform(model.T_cj.R[i], model.T_cj.p[i])
        T_ci = T_cj.inverse()
        q0 = model.axes.new_zeros(model.joint_ndofs[i])
        S = J.child_subspace(jt, q0, model.axes[i], T_cj)
        S = S[:, 0] if S.shape[1] else S.new_zeros(6)
        I_body = spatial_inertia(model.mass[i], model.com[i], model.moment[i])
        per_body.append(torch.cat([
            model.T_pj.R[i].reshape(9), model.T_pj.p[i], T_ci.R.reshape(9),
            T_ci.p, model.axes[i, 0], S, I_body.reshape(36)]))
    act = list(model.actuated)
    rows = constraint_rows(model)
    bounds = {ROW_LOWER: model.q_lower, ROW_UPPER: model.q_upper,
              ROW_COULOMB: model.coulomb_friction * model.dt}
    row_reals = [bounds[kind][d].reshape(1) for d, kind in rows]
    reals = torch.cat(per_body + [
        torch.stack([model.damping, model.stiffness, model.rest_pos], 1).reshape(-1),
        torch.stack([model.tau_lower[act], model.tau_upper[act]], 1).reshape(-1),
        model.gravity, model.dt.reshape(1),
    ] + row_reals).contiguous()
    offsets = model.dof_offsets
    dof_of_body = [offsets[i] if model.joint_ndofs[i] else -1 for i in range(nb)]
    ints = torch.tensor(
        list(model.parents) + [JOINT_CODES[t] for t in model.joint_types]
        + dof_of_body + act + [d for d, _ in rows] + [kind for _, kind in rows],
        dtype=torch.int32, device=model.device)
    return reals, ints


# Operation counts of device_step (csrc/step.cuh), for the kernels'
# least-work bounds. Each kind of operation costs 1 in a plain step; a
# forward-mode tangent (Dual<T>, csrc/common.cuh) adds TANGENT_OPS[kind] to
# it. "add" is a sum or difference of two variables, a negation, or a
# constant minus a variable; "add_c" a variable plus or minus a constant;
# "mul" a product of two variables; "mul_c" a product with (or quotient by)
# a constant; "div" a quotient by a variable. Operations on the model's
# constants alone are not counted.
TANGENT_OPS = {"add": 1, "add_c": 0, "mul": 3, "mul_c": 1, "div": 3,
               "sin": 2, "cos": 3, "sqrt": 2}


def _ops(k: int = 1, **kinds) -> Counter:
    return Counter({kind: k * n for kind, n in kinds.items()})


def _mv3(const: bool) -> Counter:
    return _ops(add=6, **{"mul_c" if const else "mul": 9})


def _mm3_c() -> Counter:
    return _ops(mul_c=27, add=18)


def _cross3(const: bool = False) -> Counter:
    return _ops(add=3, **{"mul_c" if const else "mul": 6})


def _mv6(const: bool) -> Counter:
    return _ops(add=30, **{"mul_c" if const else "mul": 36})


def _ad_inv_apply(const_v: bool) -> Counter:
    return _cross3(const_v) + _ops(add=3) + _mv3(const_v) + _mv3(False)


_AD_DUAL_APPLY = _mv3(False) + _mv3(False) + _cross3() + _ops(add=3)
_AD_MOTION = _ops(3, mul=6, add=3) + _ops(add=3)          # also ad_dual
# expm_so3 on its sin/cos branch, the shorter of its two; the Taylor branch
# (theta^2 < 1e-8) costs 4 plain operations more and the same tangent.
_EXPM_SO3 = (_ops(mul=3, add=2) + _ops(sqrt=1, sin=1, cos=1, div=2, add=1)
             + _ops(add=3) + _ops(mul=27, add=18) + _ops(mul=18, add=9) + _ops(add_c=3))


def step_op_kinds(model: Model) -> Counter:
    """Operations of one device_step on this model, by kind, following
    csrc/step.cuh line by line."""
    check_model(model)
    nb, nq = model.num_bodies, model.nq
    dof = [model.dof_offsets[i] if model.joint_ndofs[i] else -1 for i in range(nb)]
    c = _ops(nq, add_c=1, mul_c=3, add=3)                  # tau
    for i, jt in enumerate(model.joint_types):             # forward sweep
        if jt == "revolute":
            c += _ops(mul_c=3) + _EXPM_SO3
        elif jt == "prismatic":
            c += _ops(mul_c=3)
        c += _mm3_c() + _mv3(True) + _ops(add_c=3) + _mm3_c() + _mv3(True) + _ops(add=3)
        c += _ops(mul_c=6)                                 # vJ
        if model.parents[i] >= 0:
            c += _ad_inv_apply(False)
        c += _ops(add=6) + _AD_MOTION + _mv6(True) + _AD_MOTION
    for i in reversed(range(nb)):                          # backward sweep
        if dof[i] >= 0:
            c += (_mv6(True) + _ops(mul_c=12, add=10) + _ops(div=1, add=1)
                  + _ops(36, mul=2, add=1) + _mv6(False) + _ops(mul=1) + _ops(6, add=2, mul=1))
        else:
            c += _mv6(False) + _ops(add=6)
        if model.parents[i] >= 0:
            col = _ad_inv_apply(False) + _mv6(False) + _AD_DUAL_APPLY + _ops(add=6)
            c += _ops(6, **col) + _AD_DUAL_APPLY + _ops(add=6)
    for i in range(nb):                                    # accelerations
        c += _ad_inv_apply(model.parents[i] < 0) + _ops(add=6)
        if dof[i] >= 0:
            c += _ops(mul=6, add=5) + _ops(add=1, mul=1) + _ops(mul_c=6, add=6)
    return c + _ops(nq, mul_c=2, add=2)                    # Euler update


def step_ops(model: Model) -> tuple:
    """(plain, tangent): the operations of one plain device step, and those
    that one forward-mode tangent direction adds to it."""
    kinds = step_op_kinds(model)
    return sum(kinds.values()), sum(TANGENT_OPS[k] * n for k, n in kinds.items())


# Operation counts of the constrained device steps (csrc/step.cuh
# frozen_step, class_step), kind by kind as step_op_kinds, for K2 with
# classes, K4 and K6. Selections (clip, max, abs, the comparisons of the
# LCP's active set) are not arithmetic and are not counted; every
# arithmetic operation of these functions runs whatever the data.


def _mass_matrix_ops(model: Model) -> Counter:
    nb = model.num_bodies
    dof = [model.dof_offsets[i] if model.joint_ndofs[i] else -1 for i in range(nb)]
    c = Counter()
    for i in range(nb):                                    # composite inertias
        if model.parents[i] >= 0:
            col = _ad_inv_apply(False) + _mv6(False) + _AD_DUAL_APPLY + _ops(add=6)
            c += _ops(6, **col)
    for i in range(nb):                                    # F = Ic S up the chain
        if dof[i] < 0:
            continue
        c += _mv6(True) + _ops(mul_c=6, add=5)
        j = i
        while model.parents[j] >= 0:
            c += _AD_DUAL_APPLY
            j = model.parents[j]
            if dof[j] >= 0:
                c += _ops(mul_c=6, add=5)
    return c


def _inv_spd_ops(n: int) -> Counter:
    return _ops(n, div=1, mul=2 * n) + _ops(n * (n - 1) * 2 * n, mul=1, add=1)


def _rows_ops(model: Model, planner: bool) -> Counter:
    from nimblephysics_tpu_torch.ops.contact import coulomb_dofs, limited_dofs

    n_lim, n_coul = 2 * len(limited_dofs(model)), len(coulomb_dofs(model))
    m, nq = n_lim + n_coul, model.nq
    c = _ops(n_lim, mul_c=1) + _ops(n_coul, add=1)         # b
    if not planner:
        c += _ops(n_lim, add_c=1)                          # q - limit
    return c + _ops(nq * m, mul_c=1) + _ops(m * m, mul_c=1) + _ops(m, add_c=1)


def _dot(m: int) -> Counter:
    return _ops(mul=m, add=m - 1)


def _pcg_ops(m: int, n_cg: int) -> Counter:
    it = (_ops(2 * m, **_dot(m)) + _ops(m, mul=1, add=1) + _dot(m) + _ops(add_c=1, div=1)
          + _ops(2 * m, mul=1, add=1) + _ops(m, div=1) + _dot(m) + _ops(add_c=1, div=1)
          + _ops(m, mul=1, add=1))
    return _ops(m, div=1) + _dot(m) + _ops(n_cg, **it)


def _solve_frozen_ops(m: int, n_cg: int) -> Counter:
    return (_ops(m * m, mul_c=3) + _ops(m, add_c=1) + _ops(m, mul_c=1)   # Qf, rhs
            + _ops(mul_c=1, mul=1)                                     # reg
            + _ops(2 * m, **_dot(m)) + _ops(m, add=1)                  # diag, Qf^T rhs
            + _pcg_ops(m, n_cg) + _ops(m, mul_c=2))


def _comp_residual_ops(m: int) -> Counter:
    return _ops(m, **_dot(m)) + _ops(m, add=2)


def _lane_lcp_ops(m: int) -> Counter:
    sub = (_ops(m, mul_c=1) + _ops(m, **_dot(m)) + _ops(m, add=1, mul_c=1)   # x_B, rhs
           + _ops(m * m, mul_c=2) + _ops(m, add_c=1) + _ops(mul_c=1, mul=1)  # Af, reg
           + _ops(m * m, **_dot(m)) + _ops(m, add=1) + _ops(m, **_dot(m))    # Af^T Af, Af^T rhs
           + _inv_spd_ops(m) + _ops(m, **_dot(m)) + _ops(m, mul_c=1, add=1))
    rnd = sub + _ops(m, **_dot(m)) + _ops(m, add=1) + _comp_residual_ops(m)
    sweep = _ops(m, **_dot(m)) + _ops(m, add=4, mul=1)
    return (_comp_residual_ops(m) + _ops(3, **rnd) + _ops(m, div=1) + _ops(8, **sweep)
            + _comp_residual_ops(m))


def _constrained_ops(model: Model, planner: bool) -> Counter:
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    m, nq = lcp_dim(model), model.nq
    return (step_op_kinds(model) + _mass_matrix_ops(model) + _inv_spd_ops(nq)
            + _rows_ops(model, planner) + _ops(nq, **_dot(m)) + _ops(nq, add=1))


def frozen_step_op_kinds(model: Model, n_cg: int) -> Counter:
    """Operations of one frozen_step (csrc/step.cuh) by kind, its PCG at
    n_cg iterations."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    return _constrained_ops(model, True) + _solve_frozen_ops(lcp_dim(model), n_cg)


def class_step_op_kinds(model: Model) -> Counter:
    """Operations of one class_step (csrc/step.cuh) by kind."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    return _constrained_ops(model, False) + _lane_lcp_ops(lcp_dim(model))


def frozen_step_tangent_ops(model: Model, n_cg: int) -> int:
    """The operations one forward-mode tangent adds to a frozen_step:
    TANGENT_OPS over the step outside its solve, and the Dual overload of
    solve_frozen, whose tangent is one more PCG (the implicit tangent of
    the linear solve) with its right-hand side."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    m = lcp_dim(model)
    outside = _constrained_ops(model, True)
    c = sum(TANGENT_OPS[k] * n for k, n in outside.items())
    c += 3 * m * m + m + 2 * m * m + 1 + 4               # Qf, rhs, tie rule of max|Qf|, reg
    c += m * (3 * m + m - 1)                             # Qf^T rhs on duals
    c += 2 * m * (2 * m - 1)                             # Qf x_C, dQf x_C
    c += m * (2 * (2 * m - 1) + 4)                       # right-hand side of the tangent
    c += sum(_pcg_ops(m, n_cg).values()) + 2 * m         # tangent PCG, x = R (cmask x_C)
    return c


def frozen_step_ops(model: Model, n_cg: int) -> tuple:
    """(plain, tangent) operations of one frozen_step, as step_ops."""
    return sum(frozen_step_op_kinds(model, n_cg).values()), frozen_step_tangent_ops(model, n_cg)


def class_step_ops(model: Model) -> int:
    return sum(class_step_op_kinds(model).values())
