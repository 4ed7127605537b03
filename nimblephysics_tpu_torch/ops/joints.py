"""Per-joint-type kinematics: relative transform Q(q), motion subspace S and
explicit position integration.

PyTorch counterpart of ``nimblephysics_tpu/ops/joints.py`` for the joint
types of this slice: ``weld``, ``revolute`` and ``prismatic``. ``q`` and
``v`` carry leading batch dimensions, ``axes`` (3, 3) and ``T_cj`` are the
model's per-joint leaves.

Conventions: child-to-parent transform T_pc = T_pj o Q(q) o T_cj^-1, and
the child-frame relative Jacobian is S_child = Ad(T_cj) S_joint.
"""

from __future__ import annotations

import torch

from nimblephysics_tpu_torch.ops import lie
from nimblephysics_tpu_torch.ops.lie import Transform

SUPPORTED = ("weld", "revolute", "prismatic")


def _unsupported(jtype: str) -> NotImplementedError:
    return NotImplementedError(
        f"joint type {jtype!r} is not ported yet (ROADMAP queue A, M1: "
        "ops/joints.py beyond weld/revolute/prismatic)"
    )


def joint_transform(jtype: str, q: torch.Tensor, axes: torch.Tensor) -> Transform:
    """Relative transform Q(q) in the joint frame; q is (..., ndof)."""
    batch = q.shape[:-1]
    eye = lie._eye3(axes, batch)
    zero3 = axes.new_zeros(batch + (3,))
    if jtype == "weld":
        return Transform(eye, zero3)
    if jtype == "revolute":
        return Transform(lie.expm_so3(axes[0] * q[..., 0:1]), zero3)
    if jtype == "prismatic":
        return Transform(eye, axes[0] * q[..., 0:1])
    raise _unsupported(jtype)


def joint_subspace(jtype: str, q: torch.Tensor, axes: torch.Tensor) -> torch.Tensor:
    """Motion subspace S_joint (6, ndof); constant for the ported types."""
    zero3 = axes.new_zeros(3)
    if jtype == "weld":
        return axes.new_zeros((6, 0))
    if jtype == "revolute":
        return torch.cat([axes[0], zero3])[:, None]
    if jtype == "prismatic":
        return torch.cat([zero3, axes[0]])[:, None]
    raise _unsupported(jtype)


def child_subspace(
    jtype: str, q: torch.Tensor, axes: torch.Tensor, T_cj: Transform
) -> torch.Tensor:
    """S in the child body frame: Ad(T_cj) S_joint, (6, ndof)."""
    return lie.Ad(T_cj) @ joint_subspace(jtype, q, axes)


def child_subspace_and_rate(
    jtype: str, q: torch.Tensor, v: torch.Tensor, axes: torch.Tensor,
    T_cj: Transform,
):
    """(S_child, S_dot q_dot): the bias term is zero for the ported types,
    whose subspace does not depend on q."""
    S = child_subspace(jtype, q, axes, T_cj)
    return S, S.new_zeros(S.shape[:-1])


def integrate_position(
    jtype: str, q: torch.Tensor, v: torch.Tensor, dt, axes: torch.Tensor,
    T_cj: Transform,
) -> torch.Tensor:
    """Explicit position update q + v dt (linear for the ported types)."""
    if jtype not in SUPPORTED:
        raise _unsupported(jtype)
    return q + v * dt
