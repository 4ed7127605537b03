"""Pack a Model into the flat buffers of the device step (csrc/step.cuh).

Shared by the linearize (K3) and rollout (K2) kernels. The layout is the
one documented at the top of ``csrc/step.cuh``: a reals buffer in the
model's dtype and an int32 buffer with the topology, both on the model's
device.
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


def check_model(model: Model) -> None:
    """Raise unless the device step covers this model's joints. Which
    (bodies, dofs, actions) shapes are built is NPTT_STEP_SHAPES in
    csrc/step.cuh; the launchers refuse any other."""
    bad = [t for t in model.joint_types if t not in JOINT_CODES]
    if bad:
        raise NotImplementedError(
            f"the device step covers weld/revolute/prismatic joints, not {bad}")


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
    reals = torch.cat(per_body + [
        torch.stack([model.damping, model.stiffness, model.rest_pos], 1).reshape(-1),
        torch.stack([model.tau_lower[act], model.tau_upper[act]], 1).reshape(-1),
        model.gravity, model.dt.reshape(1),
    ]).contiguous()
    offsets = model.dof_offsets
    dof_of_body = [offsets[i] if model.joint_ndofs[i] else -1 for i in range(nb)]
    ints = torch.tensor(
        list(model.parents) + [JOINT_CODES[t] for t in model.joint_types]
        + dof_of_body + act, dtype=torch.int32, device=model.device)
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
