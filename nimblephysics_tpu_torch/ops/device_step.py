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


_PACKED_HOST: "weakref.WeakKeyDictionary[Model, tuple]" = weakref.WeakKeyDictionary()


def pack_model_host(model: Model):
    """pack_model's (reals, ints) as CPU tensors, for a kernel that takes
    the model by value in its launch parameters (K6, csrc/classes.cu):
    copied from the model's device once per packing."""
    packed = pack_model(model)
    hit = _PACKED_HOST.get(model)
    if hit is not None and hit[0] is packed:
        return hit[1]
    host = tuple(t.detach().cpu().contiguous() for t in packed)
    _PACKED_HOST[model] = (packed, host)
    return host


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
# ... and by kind (csrc/common.cuh Dual): a product's tangent a.d b + a b.d
# is two products and a sum, a quotient's (a.d - q b.d) / b a product, a sum
# and a quotient, sqrt's x.d / (2 s) a product (of the constant 2 built in
# the arithmetic type) and a quotient.
TANGENT_KINDS = {"add": {"add": 1}, "add_c": {}, "mul": {"mul": 2, "add": 1},
                 "mul_c": {"mul_c": 1}, "div": {"div": 1, "mul": 1, "add": 1},
                 "sin": {"cos": 1, "mul": 1}, "cos": {"sin": 1, "mul": 1, "add": 1},
                 "sqrt": {"mul": 1, "div": 1}}
# csrc/frozen_group.cuh kK5Group and kK4Group: the lanes of K5's and of
# K4's (worm instance) group per point
K5_GROUP = 16
K4_GROUP = 16


def _ops(k: int = 1, **kinds) -> Counter:
    return Counter({kind: k * n for kind, n in kinds.items()})


def _mv3(const: bool) -> Counter:
    return _ops(add=6, **{"mul_c" if const else "mul": 9})


def _cross3(const: bool = False) -> Counter:
    return _ops(add=3, **{"mul_c" if const else "mul": 6})


def _mv6(const: bool) -> Counter:
    return _ops(add=30, **{"mul_c" if const else "mul": 36})


def _ad_inv_apply(const_v: bool) -> Counter:
    return _cross3(const_v) + _ops(add=3) + _mv3(const_v) + _mv3(False)


_AD_DUAL_APPLY = _mv3(False) + _mv3(False) + _cross3() + _ops(add=3)
def step_op_kinds(model: Model) -> Counter:
    """Operations of one device_step on this model, by kind (csrc/step.cuh:
    forward_dynamics_impl with every scalar type plain, then the Euler
    update; typed_step_op_kinds follows the code line by line)."""
    check_model(model)
    return typed_step_op_kinds(model, False, False, False)


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


def _world_frames_ops(model: Model) -> Counter:
    """csrc/step.cuh world_frames."""
    c = Counter()
    for i in range(model.num_bodies):
        if model.parents[i] >= 0:
            c += _ops(mul=27, add=18) + _mv3(False) + _ops(add=3)
    return c


def _slot_jacobian_ops(model: Model) -> list:
    """csrc/step.cuh slot_jacobian, per contact slot: its point and its
    point Jacobian over its body's ancestors' dof columns."""
    nds = model.joint_ndofs
    out = []
    for ia, _, n in enumerate_pairs(model):
        a = model.shapes[ia].body_index
        cols = 0
        while a >= 0:
            cols += nds[a]
            a = model.parents[a]
        out += [_mv3(True) + _ops(add=3)
                + _ops(cols, **(_mv3(True) + _mv3(True) + _cross3() + _cross3() + _ops(add=6)))] * n
    return out


def _contact_rows_ops(model: Model) -> Counter:
    """csrc/step.cuh contact_rows: the world transforms, then per slot its
    point Jacobian, its three rows and their b."""
    nq = model.nq
    c = _world_frames_ops(model)
    for jac in _slot_jacobian_ops(model):
        c += jac + _ops(3 * nq, mul_c=3, add=2) + _ops(3, mul=nq, add=nq)
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


def _tangent_kinds(c: Counter) -> Counter:
    """The operations the tangents of c's operations add, by kind."""
    out = Counter()
    for kind, n in c.items():
        for k, m in TANGENT_KINDS[kind].items():
            out[k] += n * m
    return out


def _group_sums(m: int, g: int, n: int = 1) -> Counter:
    """n sums over m rows held by a group of g lanes by its butterfly
    (csrc/frozen_group.cuh, the groups' sum()): the m products, each lane's partial
    (a sum per owned row after its first) and log2(g) sums on every
    lane."""
    return _ops(n, mul=m, add=m - min(g, m) + g * (g.bit_length() - 1))


def _vjp_parts(model: Model, n_cg: int, g: int) -> dict:
    """K5's operations for one point by part, as csrc/linearize.cu's
    linearize_vjp_group does them on a group of g lanes: "dyn", the step's
    dynamics on lane 0 (forward_dynamics, mass_matrix, inv_spd,
    world_frames) and every lane's v* and q'; "primal", the rows, the
    normal equations, the primal and nq adjoint PCGs and the point's
    coefficients G_k, H_k, c_k (without the tie rule of max|Qf|, which adds operations only where an entry of C A R
    attains max|Qf| >= 1); "col" and "qcol", the values of one direction's
    dual inputs (every direction's: forward_dynamics and v*; a direction of
    q's besides: mass_matrix, world_frames and the contact rows), and
    "contract" and "qcontract", the contractions that follow them; "rows",
    the part of "primal" before the PCGs (the rows and the normal
    equations, which K4's group body shares)."""
    from nimblephysics_tpu_torch.ops.contact import coulomb_dofs, lcp_dim, limited_dofs

    m, nq, ns = lcp_dim(model), model.nq, total_slots(model)
    c0, nr = 3 * ns, nq + 1
    mr = m - c0
    n_lim, n_coul = 2 * len(limited_dofs(model)), len(coulomb_dofs(model))
    euler = _ops(nq, mul_c=2, add=2)
    # the world frames serve the contact rows only
    frames = _world_frames_ops(model) if ns else Counter()
    dyn = (step_op_kinds(model) - euler + _mass_matrix_ops(model) + _inv_spd_ops(nq)
           + frames + _ops(g, **euler))
    rows = Counter()
    for jac in _slot_jacobian_ops(model):              # J, b and MJ of contact rows
        rows += _ops(3, **(jac + _ops(nq, mul_c=3, add=2) + _ops(mul=nq, add=nq)
                           + _ops(nq, mul=nq, add=nq - 1)))
    rows += _ops(n_lim, mul_c=1) + _ops(n_coul, add=1) + _ops(mr * nq, mul_c=1)
    normal = (_ops(c0 * m, mul=nq, add=nq - 1) + _ops(mr * m, mul_c=1)   # A, by entries
              + _ops(m, add_c=2) + _ops(m * ns, mul_c=2, add=2)          # CFM, 1 - cm, coupling
              + _ops(m * m, mul_c=3) + _ops(m, mul_c=1)                  # Qf, rhs
              + _ops(g, mul_c=1, mul=1)                                  # reg on every lane
              + _ops(2 * m, **_dot(m)) + _ops(m, add=1))                 # diagM, bvec
    adjoint = _ops(nq * m, mul_c=2) + _ops(nq * ns, mul_c=2, add=2)
    it = (_ops(nr * m, **_dot(m)) + _ops(nr * m, mul=m + 1, add=m)      # Qp, Ap
          + _ops(nr, **_dot(m)) + _ops(nr * g, add_c=1, div=1)          # pAp, alpha
          + _ops(nr * m, mul=2, add=2, div=1)                           # x, r, z
          + _ops(nr, **_dot(m)) + _ops(nr * g, add_c=1, div=1)          # rz, beta
          + _ops(nr * m, mul=1, add=1))                                 # p
    pcg = _ops(nr * m, div=1) + _ops(nr, **_dot(m)) + _ops(n_cg, **it)
    red = 2 * nq * nq + 3 * nq
    coeffs = (_ops(nr, **(_ops(m, mul_c=2) + _ops(2 * ns, mul_c=3, add=1)))    # R x_C, R lam_k
              + _ops(nr * m, **_dot(m))                                     # Qf x_C, Qf lam_k
              + _ops(m, add=1, mul_c=1) + _ops(nq * m, mul_c=1, add=1)      # a1, a2_k
              + _group_sums(m, g, red)                                      # MJ w, J^T a, lam x_C
              + _ops(g, **(_ops(nq + nq * nq, **_dot(nq))                   # pa1, pa2_k
                           + _ops(nq * nq + nq, add=1)))                    # + M^-1[k, :], vn
              + _ops(c0 * nq * nq, mul=4, add=3)                            # G_k
              + _ops(nq ** 3, mul=2, add=2) + _ops(nq, add_c=1))            # H_k, c_k
    col = step_op_kinds(model) - _ops(nq, mul_c=1, add=1)    # forward_dynamics and v*
    qcol = _mass_matrix_ops(model) + frames
    for jac in _slot_jacobian_ops(model):
        qcol += jac + _ops(3 * nq, mul_c=3, add=2)
    return {"dyn": dyn, "primal": rows + normal + adjoint + pcg + coeffs, "rows": rows + normal,
            "col": col, "contract": _ops(nq, **_dot(nq)),
            "qcol": qcol, "qcontract": _ops(nq ** 3 + 3 * ns * nq * nq, mul=1, add=1)}


def vjp_point_op_kinds(model: Model, n_cg: int, group: int = K5_GROUP) -> Counter:
    """The operations of K5's body for one point as the code does them, by
    kind (csrc/linearize.cu linearize_vjp_group on a group of ``group``
    lanes): the dynamics, the primal and the coefficients, then per
    direction of (x, u) its inputs on dual numbers (a dual operation of a
    kind adds TANGENT_KINDS[kind]) and their contraction."""
    p = _vjp_parts(model, n_cg, group)
    k = 2 * model.nq + model.num_actions
    return (p["dyn"] + p["primal"]
            + _ops(k, **(p["col"] + _tangent_kinds(p["col"]) + p["contract"]))
            + _ops(model.nq, **(p["qcol"] + _tangent_kinds(p["qcol"]) + p["qcontract"])))


def vjp_point_ops(model: Model, n_cg: int, group: int = K5_GROUP) -> int:
    return sum(vjp_point_op_kinds(model, n_cg, group).values())


def vjp_point_least_ops(model: Model, n_cg: int) -> int:
    """The operations one point of K5's function needs, for its bound: the
    primal as one thread does it (the dynamics once, the nq + 1 PCGs with
    their sums in sequence, the coefficients G_k, H_k, c_k), then nq reverse
    sweeps of the factored form, one per row of v', each from its
    cotangents G_k, H_k, c_k on J, M and v* back to (x, u) through
    forward_dynamics, mass_matrix and the contact rows, counted as one
    tangent sweep of them without their values (the adjoint of each
    operation costs what its tangent does). The kernel runs 2 nq + na dual
    directions with their values (vjp_point_ops)."""
    p = _vjp_parts(model, n_cg, 1)
    sweep = _tangent_kinds(p["col"] + p["qcol"])
    return sum((p["dyn"] + p["primal"]).values()) + model.nq * sum(sweep.values())


def _jvp_parts(model: Model, n_cg: int, g: int) -> dict:
    """K4's operations for one point by part, as csrc/linearize.cu's
    linearize_jvp_group does them on a group of g lanes (where
    group_layout(m) holds): "dyn", the dynamics on lane 0 and every lane's
    v* and q' (K5's); "primal", the rows, the normal equations, the primal
    PCG and the fixed vectors x~, z, w = MJ x~, J^T z, pz and v' (without
    the tie rule of max|Qf|, which adds operations only where an entry of
    C A R attains max|Qf| >= 1); "col" and "qcol", the values of one
    direction's dual inputs (K5's); "contract", every direction's tangent
    right-hand side t = Qf^T s (+ R^T g on directions of q) from its dv*,
    and "qcontract" what a direction of q adds (the contact rows' and
    dM's products, h and k); "pcg", the nx + na tangent PCGs; "column",
    one direction's dv' = u + MJ R dx_C."""
    from nimblephysics_tpu_torch.ops.contact import lcp_dim

    m, nq, ns = lcp_dim(model), model.nq, total_slots(model)
    c0, k_dirs = 3 * ns, 2 * nq + model.num_actions
    v = _vjp_parts(model, n_cg, g)
    r_apply = _ops(m, mul_c=2) + _ops(2 * ns, mul_c=3, add=1)

    def pcg(nr: int) -> Counter:
        it = (_ops(nr * m, **_dot(m)) + _ops(nr * m, mul=m + 1, add=m)      # Qp, Ap
              + _ops(nr, **_dot(m)) + _ops(nr * g, add_c=1, div=1)          # pAp, alpha
              + _ops(nr * m, mul=2, add=2, div=1)                           # x, r, z
              + _ops(nr, **_dot(m)) + _ops(nr * g, add_c=1, div=1)          # rz, beta
              + _ops(nr * m, mul=1, add=1))                                 # p
        return _ops(nr * m, div=1) + _ops(nr, **_dot(m)) + _ops(n_cg, **it)

    fixed = (r_apply + _ops(m, **_dot(m)) + _ops(m, add=1, mul_c=1)         # x~, Qf x_C, z
             + _group_sums(m, g, 2 * nq)                                    # w, J^T z
             + _ops(nq, **_dot(nq)) + _ops(nq, add=1))                      # pz, v'
    contract = (_ops(m, **_dot(nq)) + _ops(m, mul_c=1, add=1)             # s
                + _ops(m, **_dot(m)))                                       # Qf^T s
    qcontract = (_ops(c0, **(_ops(2, **_dot(nq)) + _ops(nq, mul=2, add=2)))  # dJ v', dJ pz, e1, e2
                 + _ops(nq, **(_ops(2, **_dot(nq)) + _ops(add=2)))          # dM w, dM pz, g1, k
                 + _ops(nq, **_dot(nq)) + _ops(nq, add=1)                   # h, u
                 + _ops(c0, add=1)                                          # s: + dJ v'
                 + _ops(m, **_dot(nq)) + _ops(c0, add=1)                    # g = MJ^T k + dJ pz
                 + _ops(ns, **(_ops(2, **_dot(nq)) + _ops(add=4, mul_c=2)))  # coupling of g
                 + _ops(m, mul_c=2, add=1))                                 # R^T g into t
    return {"dyn": v["dyn"], "primal": v["rows"] + pcg(1) + fixed,
            "col": v["col"], "contract": contract, "qcol": v["qcol"], "qcontract": qcontract,
            "pcg": pcg(k_dirs), "column": r_apply + _ops(nq, **_dot(m)) + _ops(nq, add=1)}


def jvp_point_op_kinds(model: Model, n_cg: int, group: int = K4_GROUP) -> Counter:
    """The operations of K4's group body for one point as the code does
    them, by kind (csrc/linearize.cu linearize_jvp_group on a group of
    ``group`` lanes): the dynamics, the primal and its fixed vectors, per
    direction of (x, u) its inputs on dual numbers (a dual operation of a
    kind adds TANGENT_KINDS[kind]) and the contraction into its tangent
    right-hand side, the nx + na tangent PCGs, and the columns."""
    p = _jvp_parts(model, n_cg, group)
    k = 2 * model.nq + model.num_actions
    return (p["dyn"] + p["primal"] + p["pcg"]
            + _ops(k, **(p["col"] + _tangent_kinds(p["col"]) + p["contract"] + p["column"]))
            + _ops(model.nq, **(p["qcol"] + _tangent_kinds(p["qcol"]) + p["qcontract"])))


def point_jvp_op_kinds(model: Model, n_cg: int) -> Counter:
    """The operations of K4's one-thread body for one point (csrc/
    linearize.cu linearize_point, where no row is a contact row), by kind:
    the group body's on a group of one lane (jvp_point_op_kinds) but for
    the values of forward_dynamics and mass_matrix, which the first
    direction's dual inputs carry, and for q' and v', which K4 does not
    write (q' = q + dt v and v' = v* + w)."""
    nq = model.nq
    return (jvp_point_op_kinds(model, n_cg, 1)
            - (step_op_kinds(model) - _ops(nq, mul_c=2, add=2))
            - _mass_matrix_ops(model) - _ops(nq, mul_c=1, add=2))


def jvp_point_least_ops(model: Model, n_cg: int) -> int:
    """The operations one point of K4's function needs, for its bound: the
    primal as one thread does it (the dynamics once, the primal PCG with
    its sums in sequence, the fixed vectors), per direction of (x, u) the
    tangent sweep of its inputs without their values (forward_dynamics; on
    a direction of q also mass_matrix and the contact rows), the
    contraction into its right-hand side and its column, and the nx + na
    tangent PCGs. It replaces frozen_step_ops' count, nx + na forward-mode
    tangents of the whole frozen step (the dual A and Qf formed and
    contracted per direction), which the factored tangent does not need.
    The kernel also runs each direction's dual inputs with their values
    (jvp_point_op_kinds). Not counted: q' = q + dt v (the q' rows of fx
    are constant), and v' = v* + w where no row is a contact row (only the
    dJ v' terms read it)."""
    p = _jvp_parts(model, n_cg, 1)
    nq, k = model.nq, 2 * model.nq + model.num_actions
    sweep = _ops(k, **(_tangent_kinds(p["col"]) + p["contract"] + p["column"]))
    qsweep = _ops(nq, **(_tangent_kinds(p["qcol"]) + p["qcontract"]))
    unused = _ops(nq, mul_c=1, add=1 if total_slots(model) else 2)
    return sum((p["dyn"] + p["primal"] + p["pcg"] + sweep + qsweep - unused).values())


# K3's body (csrc/linearize_free.cu linearize_dir) runs the
# step's forward_dynamics with three scalar types (csrc/step.cuh
# forward_dynamics_impl: SQ for what depends on q alone, SV for what also
# depends on v, S for the rest), each plain or dual by the direction's
# kind, so an operation's tangent depends on which of its operands are
# dual: a product of a dual and a plain variable adds one product, not two
# and a sum, and a sum of a dual and a plain variable adds nothing (but a
# plain variable minus a dual one, whose tangent is negated). _Op is a
# counting scalar with those rules (csrc/common.cuh Dual over the host
# build's counting scalar); _typed_dynamics follows forward_dynamics_impl
# line by line on it, every array declared with the type the code gives
# it. Model constants are Python floats, counted as the host build counts
# double constants.


class _Op:
    __slots__ = ("dual", "c")

    def __init__(self, dual: bool, c: Counter):
        self.dual, self.c = dual, c

    def _bin(self, o, kind_vv, kind_vc, dual_rule):
        c = self.c
        if not isinstance(o, _Op):                       # variable op constant
            c[kind_vc] += 2 if self.dual and kind_vc == "mul_c" else 1
            return _Op(self.dual, c)
        if not (self.dual or o.dual):
            c[kind_vv] += 1
            return _Op(False, c)
        for k, n in dual_rule(self.dual, o.dual).items():
            c[k] += n
        return _Op(True, c)

    def __add__(self, o):
        return self._bin(o, "add", "add_c", lambda a, b: {"add": 2 if a and b else 1})

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "add", "add_c", lambda a, b: {"add": 1 if a and not b else 2})

    def __rsub__(self, o):                               # constant - variable
        self.c["add"] += 2 if self.dual else 1
        return _Op(self.dual, self.c)

    def __neg__(self):
        self.c["add"] += 2 if self.dual else 1
        return _Op(self.dual, self.c)

    def __mul__(self, o):
        return self._bin(o, "mul", "mul_c",
                         lambda a, b: {"mul": 3, "add": 1} if a and b else {"mul": 2})

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, _Op):
            self.c["mul_c"] += 2 if self.dual else 1
            return _Op(self.dual, self.c)
        return self._bin(o, "div", "mul_c",
                         lambda a, b: {"div": 2} if a and not b
                         else {"div": 2, "mul": 1, "add": 1})

    def __rtruediv__(self, o):                           # constant / variable
        if self.dual:
            self.c.update({"div": 2, "mul": 1, "add": 1})
        else:
            self.c["div"] += 1
        return _Op(self.dual, self.c)


def _op_sin(x):
    x.c.update({"sin": 1, "cos": 1, "mul": 1} if x.dual else {"sin": 1})
    return _Op(x.dual, x.c)


def _op_cos(x):
    x.c.update({"cos": 1, "sin": 1, "add": 1, "mul": 1} if x.dual else {"cos": 1})
    return _Op(x.dual, x.c)


def _op_sqrt(x):
    x.c.update({"sqrt": 1, "mul": 1, "div": 1} if x.dual else {"sqrt": 1})
    return _Op(x.dual, x.c)


def _typed_dynamics(model: Model, dq: bool, dv: bool, df: bool, c: Counter) -> tuple:
    """The operations of forward_dynamics_impl on this model into ``c``,
    with SQ, SV and S dual as dq, dv and df say; the sin/cos branch of
    Rodrigues' formula. Returns (q, v, qdd) for the Euler update."""
    nb, nq, na = model.num_bodies, model.nq, model.num_actions
    nds, types, parents = model.joint_ndofs, model.joint_types, model.parents
    dofs = [sum(nds[:i]) for i in range(nb)]
    K = 0.5                                              # a model constant

    def var(dual):
        return _Op(dual, c)

    def cast(x, dual):                                   # assignment to a declared type
        return x if isinstance(x, _Op) and x.dual == dual else _Op(dual, c)

    def mv3(R, x):
        return [R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2] for i in range(3)]

    def mtv3(R, x):
        return [R[i] * x[0] + R[3 + i] * x[1] + R[6 + i] * x[2] for i in range(3)]

    def mm3(A, B):
        return [A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
                for i in range(3) for j in range(3)]

    def cross3(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def ad_inv_apply(R, p, V, o):                        # out type o
        pxw = [cast(x, o) for x in cross3(p, V)]
        d = [cast(V[3 + i] - pxw[i], o) for i in range(3)]
        return [cast(x, o) for x in mtv3(R, V) + mtv3(R, d)]

    def ad_dual_apply(R, p, F, o):
        Rn = [cast(x, o) for x in mv3(R, F)]
        Rf = [cast(x, o) for x in mv3(R, F[3:])]
        pxRf = [cast(x, o) for x in cross3(p, Rf)]
        return [cast(Rn[i] + pxRf[i], o) for i in range(3)] + Rf

    def ad_motion(V, W):
        a, b = cross3(V[3:], W), cross3(V, W[3:])
        return cross3(V, W) + [a[i] + b[i] for i in range(3)]

    def ad_dual(V, F, o):
        a, b = cross3(V, F), cross3(V[3:], F[3:])
        return [cast(a[i] + b[i], o) for i in range(3)] + [cast(x, o) for x in cross3(V, F[3:])]

    def mv6(A, x, o):
        out = []
        for i in range(6):
            s = cast(A[6 * i] * x[0], o)
            for j in range(1, 6):
                s = cast(s + A[6 * i + j] * x[j], o)
            out.append(s)
        return out

    def inv_spd2(D):
        rows = [D[0] + [var(dq), var(dq)], D[1] + [var(dq), var(dq)]]
        for k in range(2):
            inv = cast(1.0 / rows[k][k], dq)
            prow = [cast(rows[k][j] * inv, dq) for j in range(4)]
            for i in range(2):
                rows[i] = prow if i == k else [cast(rows[i][j] - rows[i][k] * prow[j], dq)
                                               for j in range(4)]
        return [rows[0][2:], rows[1][2:]]

    q = [var(dq) for _ in range(nq)]
    v = [var(dv) for _ in range(nq)]
    u = [var(df) for _ in range(na)]
    tau = [var(df) for _ in range(nq)]
    for a, da in enumerate(model.actuated):
        tau[da] = u[a]
    for d in range(nq):
        tau[d] = cast(tau[d] + (-K) * (q[d] - K + v[d] * K) + (-K) * v[d], df)
    R, p, V, cc, pA, IA = [None] * nb, [None] * nb, [None] * nb, [None] * nb, [None] * nb, [None] * nb
    for i in range(nb):                                  # forward sweep
        nd, jt, par = nds[i], types[i], parents[i]
        qi, vi = (q[dofs[i]], v[dofs[i]]) if nd else (var(dq), var(dv))
        qj, vj = (q[dofs[i] + 1], v[dofs[i] + 1]) if nd == 2 else (var(dq), var(dv))
        Rq, pq = [var(dq) for _ in range(9)], [var(dq) for _ in range(3)]
        if jt == "revolute":
            w = [K * qi for _ in range(3)]
            th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
            th = _op_sqrt(th2)
            A = _op_sin(th) / th
            B = (1.0 - _op_cos(th)) / th2
            z = var(dq)
            W = [z, -w[2], w[1], w[2], z, -w[0], -w[1], w[0], z]
            W2 = mm3(W, W)
            Rq = [A * W[k] + B * W2[k] for k in range(9)]
            for k in (0, 4, 8):
                Rq[k] = Rq[k] + 1.0
        elif jt == "prismatic":
            pq = [K * qi for _ in range(3)]
        elif jt == "translational2d":
            pq = [K * qi + K * qj for _ in range(3)]
        const9, const3 = [K] * 9, [K] * 3
        RA = mm3(const9, Rq)
        tmp = mv3(const9, pq)
        pAq = [tmp[k] + K for k in range(3)]
        R[i] = mm3(RA, const9)
        tmp = mv3(RA, const3)
        p[i] = [tmp[k] + pAq[k] for k in range(3)]
        vJ = [cast(K * vi, dv) for _ in range(6)]
        if nd == 2:
            vJ = [cast(vJ[k] + K * vj, dv) for k in range(6)]
        Vpar = [var(dv) for _ in range(6)]
        if par >= 0:
            Vpar = ad_inv_apply(R[i], p[i], V[par], dv)
        V[i] = [cast(Vpar[k] + vJ[k], dv) for k in range(6)]
        cc[i] = [cast(x, dv) for x in ad_motion(V[i], vJ)]
        IV = mv6([K] * 36, V[i], dv)
        pA[i] = ad_dual(V[i], IV, df)
        IA[i] = [var(dq) for _ in range(36)]
    U = [[[var(dq)] * 6, [var(dq)] * 6] for _ in range(nb)]
    Dinv = [[[var(dq)] * 2, [var(dq)] * 2] for _ in range(nb)]
    uu = [[var(df), var(df)] for _ in range(nb)]
    for i in reversed(range(nb)):                        # backward sweep
        nd, par = nds[i], parents[i]
        Sv = [K] * 6
        if nd == 1:
            sp = cast(Sv[0] * pA[i][0], df)
            U[i][0] = mv6(IA[i], Sv, dq)
            D = cast(Sv[0] * U[i][0][0], dq)
            for k in range(1, 6):
                D = cast(D + Sv[k] * U[i][0][k], dq)
                sp = cast(sp + Sv[k] * pA[i][k], df)
            Dinv[i][0][0] = cast(1.0 / D, dq)
            te = tau[dofs[i]]
            uu[i][0] = cast(te - sp, df)
            Ia = [cast(IA[i][6 * r + k] - (U[i][0][r] * Dinv[i][0][0]) * U[i][0][k], dq)
                  for r in range(6) for k in range(6)]
            Iac = mv6(Ia, cc[i], dv)
            Du = cast(Dinv[i][0][0] * uu[i][0], df)
            pa = [cast(pA[i][k] + Iac[k] + U[i][0][k] * Du, df) for k in range(6)]
        elif nd == 2:
            U[i][0], U[i][1] = mv6(IA[i], Sv, dq), mv6(IA[i], Sv, dq)
            D = [[None, None], [None, None]]
            sp = [None, None]
            for a in range(2):
                for b in range(2):
                    D[a][b] = cast(Sv[0] * U[i][b][0], dq)
                    for k in range(1, 6):
                        D[a][b] = cast(D[a][b] + Sv[k] * U[i][b][k], dq)
                sp[a] = cast(Sv[0] * pA[i][0], df)
                for k in range(1, 6):
                    sp[a] = cast(sp[a] + Sv[k] * pA[i][k], df)
            Dinv[i] = inv_spd2(D)
            te = [tau[dofs[i]], tau[dofs[i] + 1]]
            uu[i] = [cast(te[0] - sp[0], df), cast(te[1] - sp[1], df)]
            UD = [[cast(U[i][0][r] * Dinv[i][0][b] + U[i][1][r] * Dinv[i][1][b], dq)
                   for b in range(2)] for r in range(6)]
            Ia = [cast(IA[i][6 * r + k] - (UD[r][0] * U[i][0][k] + UD[r][1] * U[i][1][k]),
                       dq) for r in range(6) for k in range(6)]
            Iac = mv6(Ia, cc[i], dv)
            Du = [cast(Dinv[i][a][0] * uu[i][0] + Dinv[i][a][1] * uu[i][1], df)
                  for a in range(2)]
            pa = [cast(pA[i][k] + Iac[k] + (U[i][0][k] * Du[0] + U[i][1][k] * Du[1]), df)
                  for k in range(6)]
        else:
            Ia = IA[i]
            Iac = mv6(Ia, cc[i], dv)
            pa = [cast(pA[i][k] + Iac[k], df) for k in range(6)]
        if par >= 0:
            for j in range(6):
                e = [var(dq) for _ in range(6)]
                x = ad_inv_apply(R[i], p[i], e, dq)
                y = mv6(Ia, x, dq)
                col = ad_dual_apply(R[i], p[i], y, dq)
                for r in range(6):
                    IA[par][6 * r + j] = cast(IA[par][6 * r + j] + col[r], dq)
            f = ad_dual_apply(R[i], p[i], pa, df)
            pA[par] = [cast(pA[par][k] + f[k], df) for k in range(6)]
    a = [None] * nb                                      # accelerations
    qdd = [var(df) for _ in range(nq)]
    for i in range(nb):
        nd, par = nds[i], parents[i]
        Sv = [K] * 6
        ap = [var(df) for _ in range(6)]
        if par < 0:
            ap = ad_inv_apply(R[i], p[i], [K] * 6, df)
        else:
            ap = ad_inv_apply(R[i], p[i], a[par], df)
        ap = [cast(ap[k] + cc[i][k], df) for k in range(6)]
        if nd == 1:
            Ua = cast(U[i][0][0] * ap[0], df)
            for k in range(1, 6):
                Ua = cast(Ua + U[i][0][k] * ap[k], df)
            qi = cast(Dinv[i][0][0] * (uu[i][0] - Ua), df)
            qdd[dofs[i]] = qi
            a[i] = [cast(ap[k] + Sv[k] * qi, df) for k in range(6)]
        elif nd == 2:
            r = []
            for b in range(2):
                Ua = cast(U[i][b][0] * ap[0], df)
                for k in range(1, 6):
                    Ua = cast(Ua + U[i][b][k] * ap[k], df)
                r.append(cast(uu[i][b] - Ua, df))
            q0 = cast(Dinv[i][0][0] * r[0] + Dinv[i][0][1] * r[1], df)
            q1 = cast(Dinv[i][1][0] * r[0] + Dinv[i][1][1] * r[1], df)
            qdd[dofs[i]], qdd[dofs[i] + 1] = q0, q1
            a[i] = [cast(ap[k] + (Sv[k] * q0 + Sv[k] * q1), df) for k in range(6)]
        else:
            a[i] = list(ap)
    return q, v, qdd


def typed_step_op_kinds(model: Model, dq: bool, dv: bool, df: bool,
                        column: bool = False) -> Counter:
    """The operations of forward_dynamics_impl with SQ, SV and S dual as
    dq, dv and df say (all plain: step_op_kinds' dynamics), then, with
    ``column``, K3's column of the direction (csrc/linearize_free.cu
    linearize_direction: q + v dt where v is dual, v + dt qdd), else
    device_step's Euler update."""
    c = Counter()
    q, v, qdd = _typed_dynamics(model, dq, dv, df, c)
    for d in range(model.nq):
        if dv or not column:
            q[d] + v[d] * 0.5
        v[d] + 0.5 * qdd[d]
    return +c


def k3_point_op_kinds(model: Model) -> Counter:
    """The operations of K3's body for one point, by kind (csrc/
    linearize_free.cu linearize_dir, its nx + na direction threads): a
    direction of q on dual numbers throughout, one of v with SQ plain, one
    of u with SQ and SV plain."""
    nq, na = model.nq, model.num_actions
    return (_ops(nq, **typed_step_op_kinds(model, True, True, True, column=True))
            + _ops(nq, **typed_step_op_kinds(model, False, True, True, column=True))
            + _ops(na, **typed_step_op_kinds(model, False, False, True, column=True)))


def k3_least_ops(model: Model) -> int:
    """The operations one point of K3's function needs, for its bound: one
    plain step, and per direction of (x, u) its tangent alone, with what the
    direction leaves fixed plain (typed_step_op_kinds less the step's
    values: a direction of v carries no tangent through the transforms and
    articulated inertias, one of u none through the velocities either). It
    replaces step_ops' count, one plain step and nx + na tangents of the
    whole step. K3's bodies also recompute values per direction
    (k3_point_op_kinds)."""
    nq, na = model.nq, model.num_actions
    plain = sum(step_op_kinds(model).values())
    kinds = ((nq, (True, True, True)), (nq, (False, True, True)), (na, (False, False, True)))
    return plain + sum(n * (sum(typed_step_op_kinds(model, *d).values()) - plain)
                       for n, d in kinds)
