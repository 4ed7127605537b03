"""Pack a Model into the flat buffers of the device step (csrc/step.cuh).

Shared by the linearize (K3, K4, K5) and rollout (K2, K6) kernels. The
layout is the one documented in ``csrc/step.cuh``: a reals buffer in the
model's dtype and an int32 buffer with the topology, both on the model's
device; a model with constraint rows appends one real per limit or
Coulomb row (its limit position or impulse bound) and, per such row, its
dof and its kind, then per contact slot its contact point in its body's
frame, the halfspace's world normal and offset, and its friction
coefficient (reals) and its body (ints).
"""

from __future__ import annotations

import weakref
from collections import Counter

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import joints as J
from nimblephysics_tpu_torch.ops.collide import enumerate_pairs, total_slots
from nimblephysics_tpu_torch.ops.lie import Transform
from nimblephysics_tpu_torch.ops.spatial import spatial_inertia

JOINT_CODES = {"weld": 0, "revolute": 1, "prismatic": 2, "translational2d": 3}
# csrc/step.cuh RowKind
ROW_LOWER, ROW_UPPER, ROW_COULOMB = 0, 1, 2
SLOT_REALS = 8          # csrc/step.cuh RowLayout::kSlotReals


def check_model(model: Model) -> None:
    """Raise unless the device step covers this model's joints and
    constraint topology. Which (bodies, dofs, actions) shapes are built is
    NPTT_STEP_SHAPES in csrc/step.cuh; the launchers refuse any other."""
    bad = [t for t in model.joint_types if t not in JOINT_CODES]
    if bad:
        raise NotImplementedError(
            f"the device step covers weld/revolute/prismatic/translational2d joints, not {bad}")
    if model.servo_dofs or model.mimic or model.loops:
        raise NotImplementedError(
            "the device step covers contact, joint-limit and Coulomb rows only (ROADMAP "
            "queue A, M4: servo, mimic and loop rows)")
    for sa, sb in _slot_pairs(model):
        if not (sa.kind == "box" and sa.body_index >= 0 and sb.kind == "halfspace"
                and sb.body_index < 0):
            raise NotImplementedError(
                f"the device step's contact rows cover a box on a body against a static "
                f"halfspace, not {sa.kind} (body {sa.body_index}) against {sb.kind} "
                f"(body {sb.body_index}) (ROADMAP queue A, M4)")


def _slot_pairs(model: Model):
    return [(model.shapes[ia], model.shapes[ib]) for ia, ib, _ in enumerate_pairs(model)]


def check_frozen_model(name: str, model: Model) -> int:
    """The row count m of a model the frozen-class kernels (K2 with classes,
    K4, K5) take: constraint rows from contact slots, joint limits or
    Coulomb friction; raises for any other, so no caller drops silently to
    a plain version."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    m = lcp_dim(model)
    if m == 0:
        raise NotImplementedError(f"{name}: the frozen-class kernels take models with "
                                  "constraint rows")
    check_model(model)
    return m


def check_contact_model(name: str, model: Model) -> int:
    """The row count m of a model the class-rollout kernel K6 takes: joint
    limit or Coulomb rows only, passing fused_class_rollout_ok; raises for
    any other."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim
    from nimblephysics_tpu_torch.ops.frozen_contact import fused_class_rollout_ok

    m = lcp_dim(model)
    if m == 0 or not fused_class_rollout_ok(model):
        raise NotImplementedError(
            f"{name}: the class-rollout kernel takes models with joint-limit or "
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
        nd = model.joint_ndofs[i]
        q0 = model.axes.new_zeros(nd)
        S = J.child_subspace(jt, q0, model.axes[i], T_cj)
        S = torch.cat([S, S.new_zeros(6, 2 - nd)], dim=1)
        axis1 = model.axes[i, 1] if nd == 2 else model.axes.new_zeros(3)
        I_body = spatial_inertia(model.mass[i], model.com[i], model.moment[i])
        per_body.append(torch.cat([
            model.T_pj.R[i].reshape(9), model.T_pj.p[i], T_ci.R.reshape(9),
            T_ci.p, model.axes[i, 0], S[:, 0], I_body.reshape(36), axis1, S[:, 1]]))
    act = list(model.actuated)
    rows = constraint_rows(model)
    bounds = {ROW_LOWER: model.q_lower, ROW_UPPER: model.q_upper,
              ROW_COULOMB: model.coulomb_friction * model.dt}
    row_reals = [bounds[kind][d].reshape(1) for d, kind in rows]
    slot_reals, slot_bodies = _pack_slots(model)
    reals = torch.cat(per_body + [
        torch.stack([model.damping, model.stiffness, model.rest_pos], 1).reshape(-1),
        torch.stack([model.tau_lower[act], model.tau_upper[act]], 1).reshape(-1),
        model.gravity, model.dt.reshape(1),
    ] + row_reals + slot_reals).contiguous()
    offsets = model.dof_offsets
    dof_of_body = [offsets[i] if model.joint_ndofs[i] else -1 for i in range(nb)]
    ints = torch.tensor(
        list(model.parents) + [JOINT_CODES[t] for t in model.joint_types]
        + dof_of_body + act + [d for d, _ in rows] + [kind for _, kind in rows]
        + slot_bodies, dtype=torch.int32, device=model.device)
    return reals, ints


def _pack_slots(model: Model):
    """Per contact slot (a box corner against a static halfspace, as
    ops/collide.py _box_halfspace): the corner in its body's frame, the
    halfspace's world normal and offset, the friction coefficient; and the
    slot's body."""
    from nimblephysics_tpu_torch.ops.collide import _box_corners, _halfspace_world

    reals, bodies = [], []
    for sa, sb in _slot_pairs(model):
        n, d = _halfspace_world(sb.params, sb.offset)
        mu = torch.sqrt(torch.clamp(sa.friction * sb.friction, min=0.0))
        for c in _box_corners(sa.params):
            reals.append(torch.cat([sa.offset.apply(c), n, d.reshape(1), mu.reshape(1)]))
            bodies.append(sa.body_index)
    return reals, bodies


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
    nds = model.joint_ndofs
    c = _ops(nq, add_c=1, mul_c=3, add=3)                  # tau
    for i, jt in enumerate(model.joint_types):             # forward sweep
        if jt == "revolute":
            c += _ops(mul_c=3) + _EXPM_SO3
        elif jt == "prismatic":
            c += _ops(mul_c=3)
        elif jt == "translational2d":
            c += _ops(3, mul_c=2, add=1)
        c += _mm3_c() + _mv3(True) + _ops(add_c=3) + _mm3_c() + _mv3(True) + _ops(add=3)
        c += _ops(mul_c=6)                                 # vJ
        if nds[i] == 2:
            c += _ops(6, mul_c=1, add=1)
        if model.parents[i] >= 0:
            c += _ad_inv_apply(False)
        c += _ops(add=6) + _AD_MOTION + _mv6(True) + _AD_MOTION
    for i in reversed(range(nb)):                          # backward sweep
        if nds[i] == 1:
            c += (_mv6(True) + _ops(mul_c=12, add=10) + _ops(div=1, add=1)
                  + _ops(36, mul=2, add=1) + _mv6(False) + _ops(mul=1) + _ops(6, add=2, mul=1))
        elif nds[i] == 2:
            c += (_ops(2, **_mv6(True)) + _ops(6, mul_c=6, add=5) + _inv_spd_ops(2)
                  + _ops(add=2) + _ops(12, mul=2, add=1) + _ops(36, mul=2, add=2)
                  + _mv6(False) + _ops(2, mul=2, add=1) + _ops(6, mul=2, add=3))
        else:
            c += _mv6(False) + _ops(add=6)
        if model.parents[i] >= 0:
            col = _ad_inv_apply(False) + _mv6(False) + _AD_DUAL_APPLY + _ops(add=6)
            c += _ops(6, **col) + _AD_DUAL_APPLY + _ops(add=6)
    for i in range(nb):                                    # accelerations
        c += _ad_inv_apply(model.parents[i] < 0) + _ops(add=6)
        if nds[i] == 1:
            c += _ops(mul=6, add=5) + _ops(add=1, mul=1) + _ops(mul_c=6, add=6)
        elif nds[i] == 2:
            c += _ops(2, mul=6, add=6) + _ops(2, mul=2, add=1) + _ops(6, mul_c=2, add=2)
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
    nb, nds = model.num_bodies, model.joint_ndofs
    c = Counter()
    for i in range(nb):                                    # composite inertias
        if model.parents[i] >= 0:
            col = _ad_inv_apply(False) + _mv6(False) + _AD_DUAL_APPLY + _ops(add=6)
            c += _ops(6, **col)
    for i in range(nb):                                    # F = Ic S up the chain
        for _ in range(nds[i]):
            c += _mv6(True) + _ops(nds[i], mul_c=6, add=5)
            j = i
            while model.parents[j] >= 0:
                c += _AD_DUAL_APPLY
                j = model.parents[j]
                c += _ops(nds[j], mul_c=6, add=5)
    return c


def _inv_spd_ops(n: int) -> Counter:
    return _ops(n, div=1, mul=2 * n) + _ops(n * (n - 1) * 2 * n, mul=1, add=1)


def _contact_rows_ops(model: Model) -> Counter:
    """csrc/step.cuh contact_rows: the world transforms, then per slot its
    point, its point Jacobian over its body's ancestors' dof columns, its
    three rows and their b."""
    nq, nds = model.nq, model.joint_ndofs
    c = Counter()
    for i in range(model.num_bodies):
        if model.parents[i] >= 0:
            c += _ops(mul=27, add=18) + _mv3(False) + _ops(add=3)
    for ia, _, n in enumerate_pairs(model):
        a = model.shapes[ia].body_index
        cols = 0
        while a >= 0:
            cols += nds[a]
            a = model.parents[a]
        per_slot = (_mv3(True) + _ops(add=3)
                    + _ops(cols, **(_mv3(True) + _mv3(True) + _cross3() + _cross3()
                                    + _ops(add=6)))
                    + _ops(3 * nq, mul_c=3, add=2) + _ops(3, mul=nq, add=nq))
        c += _ops(n, **per_slot)
    return c


def _rows_ops(model: Model, planner: bool) -> Counter:
    from nimblephysics_tpu_torch.ops.contact import coulomb_dofs, limited_dofs

    n_lim, n_coul = 2 * len(limited_dofs(model)), len(coulomb_dofs(model))
    c0, nq = 3 * total_slots(model), model.nq
    mr = n_lim + n_coul
    m = c0 + mr
    c = _ops(n_lim, mul_c=1) + _ops(n_coul, add=1)         # b
    if not planner:
        c += _ops(n_lim, add_c=1)                          # q - limit
    if c0:
        c += _contact_rows_ops(model)
        c += _ops(nq * c0, mul=nq, add=nq - 1)             # MJ, contact columns
        c += _ops(c0 * m, mul=nq, add=nq - 1)              # A, contact rows
    return c + _ops(nq * mr, mul_c=1) + _ops(mr * m, mul_c=1) + _ops(m, add_c=1)


def _dot(m: int) -> Counter:
    return _ops(mul=m, add=m - 1)


def _pcg_ops(m: int, n_cg: int) -> Counter:
    it = (_ops(2 * m, **_dot(m)) + _ops(m, mul=1, add=1) + _dot(m) + _ops(add_c=1, div=1)
          + _ops(2 * m, mul=1, add=1) + _ops(m, div=1) + _dot(m) + _ops(add_c=1, div=1)
          + _ops(m, mul=1, add=1))
    return _ops(m, div=1) + _dot(m) + _ops(n_cg, **it)


def _normal_eqs_ops(m: int, ns: int) -> Counter:
    """csrc/step.cuh frozen_normal_eqs: Qf (with the friction coupling of ns
    slots), rhs, reg, diag(Qf^T Qf) + reg and Qf^T rhs."""
    return (_ops(m * m, mul_c=3) + _ops(m * ns, mul_c=2, add=2) + _ops(m, add_c=1)
            + _ops(m, mul_c=1) + _ops(mul_c=1, mul=1) + _ops(2 * m, **_dot(m))
            + _ops(m, add=1))


def _impulses_ops(m: int, ns: int) -> Counter:
    return _ops(m, mul_c=2) + _ops(2 * ns, mul_c=3, add=1)


def _solve_frozen_ops(m: int, n_cg: int, ns: int = 0) -> Counter:
    return _normal_eqs_ops(m, ns) + _pcg_ops(m, n_cg) + _impulses_ops(m, ns)


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

    return (_constrained_ops(model, True)
            + _solve_frozen_ops(lcp_dim(model), n_cg, total_slots(model)))


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


def _vjp_parts(model: Model, n_cg: int) -> tuple:
    """K5's operations for one point, in parts (csrc/linearize.cu): the
    primal thread body by kind (the frozen solve's inputs, its normal
    equations, the primal PCG and the nq adjoint PCGs on values); then,
    per direction of (x, u), the column thread body's operations on values
    (which repeat the primal's) and on tangents, without the 4 m operations
    of each of its nq entries; Qf x_C, which each column recomputes on
    values; and m."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    m, nq, ns = lcp_dim(model), model.nq, total_slots(model)
    inputs = _constrained_ops(model, True) - _ops(nq, **_dot(m)) - _ops(nq, add=1)
    primal = (inputs + _normal_eqs_ops(m, ns) + _ops(nq + 1, **_pcg_ops(m, n_cg))
              + _impulses_ops(m, ns) + _ops(nq, **(_ops(ns, mul_c=2, add=2) + _ops(m, mul_c=2))))
    system = _ops(m * m, mul_c=3) + _ops(m * ns, mul_c=2, add=2) + _ops(m, add_c=1)
    qx = m * (2 * m - 1)
    # the inputs and Qf on dual numbers: 1 + TANGENT_OPS[kind] per operation;
    # rhs = cm b; reg = (eps qs) qs; diag(Qf^T Qf) + reg and Qf^T rhs
    values = (sum(inputs.values()) + sum(system.values()) + m + 2
              + 2 * m * (2 * m - 1) + m + qx)
    tangent = (sum(TANGENT_OPS[kd] * n for kd, n in inputs.items())
               + sum(TANGENT_OPS[kd] * n for kd, n in system.items()) + m
               + 2 * m * m + 1 + 4                       # tie rule of max|Qf|, reg
               + m * (3 * m + m - 1)                     # Qf^T rhs
               + 3 * m * (2 * m - 1) + 4 * m)            # dQf x_C, the tangent right-hand side
    return primal, values, tangent, qx, m


def vjp_point_ops(model: Model, n_cg: int) -> int:
    """The operations of K5's thread bodies for one point as the code does
    them: linearize_vjp_primal, then linearize_vjp_column per direction of
    (x, u), each on dual numbers (a dual operation of a kind costs
    1 + TANGENT_OPS[kind]; the normal equations' dual form computes
    diag(Qf^T Qf) on values and takes max|Qf|'s tangent by its tie rule)."""
    primal, values, tangent, _, m = _vjp_parts(model, n_cg)
    k = 2 * model.nq + model.num_actions
    return sum(primal.values()) + k * (values + tangent + model.nq * 4 * m)


def vjp_point_least_ops(model: Model, n_cg: int) -> int:
    """The operations one point of K5's function needs, for its bound: the
    primal frozen step with its nq adjoint PCGs and Qf x_C once, then nq
    reverse sweeps (the nq rows of v'), each counted as one tangent sweep
    without its values (the adjoint of each operation costs what its
    tangent does) and with the 4 m operations that contract one row. The
    kernel repeats the values per direction and runs 2 nq + na directions
    (vjp_point_ops)."""
    primal, _, tangent, qx, m = _vjp_parts(model, n_cg)
    return sum(primal.values()) + qx + model.nq * (tangent + 4 * m)
