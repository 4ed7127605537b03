"""World-space mappings and IK: the reference's ``Mapping`` / ``IKMapping``
and ``math::IKSolver``.

PyTorch counterpart of ``nimblephysics_tpu/neural/mappings.py``. An
``IKMapping`` maps generalized coordinates to a concatenation of
world-space body coordinates (spatial 6D, linear 3D or angular 3D per
body, and the centre of mass), so that losses and optimizers can work in
task space. The forward map is a plain differentiable function (its
Jacobians by ``torch.func``); the inverse is damped least squares.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.ops import lie


@dataclasses.dataclass(frozen=True, eq=False)
class IKMapping:
    """entries: tuple of (kind, body_index) with kind in
    {"spatial", "linear", "angular", "com"} (the body index of "com" is
    unused)."""

    model: Model
    entries: Tuple[Tuple[str, int], ...]

    @property
    def out_dim(self) -> int:
        return sum(6 if k == "spatial" else 3 for k, _ in self.entries)

    def map_positions(self, q: torch.Tensor) -> torch.Tensor:
        """q (..., nq) -> the mapped world-space positions (..., out_dim)."""
        kin = dyn.forward_kinematics(self.model, q)
        parts: List[torch.Tensor] = []
        for kind, b in self.entries:
            if kind == "com":
                parts.append(dyn.com_position(self.model, kin).expand(q.shape[:-1] + (3,)))
                continue
            T = kin.T_wb[b]
            if kind == "linear":
                parts.append(T.p)
            elif kind == "angular":
                parts.append(lie.logm_so3(T.R))
            elif kind == "spatial":
                parts.append(torch.cat([lie.logm_so3(T.R), T.p], dim=-1))
            else:
                raise ValueError(kind)
        return torch.cat(parts, dim=-1)

    def map_velocities(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Time derivative of the mapped positions along (q, v)."""
        return torch.func.jvp(self.map_positions, (q,), (v,))[1]

    def jacobian(self, q: torch.Tensor) -> torch.Tensor:
        """Real -> mapped Jacobian (out_dim, nq) at one q."""
        return torch.func.jacfwd(self.map_positions)(q)

    def inverse_positions(self, target: torch.Tensor, q_init: torch.Tensor, iters: int = 50,
                          damping: float = 1e-6) -> torch.Tensor:
        """Mapped -> real by damped least squares, a fixed iteration count."""
        return ik_solve(self.map_positions, target, q_init, iters, damping)


def ik_solve(f, target: torch.Tensor, q_init: torch.Tensor, iters: int = 50,
             damping: float = 1e-6, step_clip: float = 0.5) -> torch.Tensor:
    """Damped-least-squares IK on any differentiable task map f: q (nq,) ->
    (k,): ``iters`` steps of dq = clip((J^T J + damping I)^-1 J^T (f(q) -
    target), +-step_clip), as the JAX package's scan takes them."""
    q = q_init
    eye = torch.eye(q.shape[0], dtype=q.dtype, device=q.device)
    jac = torch.func.jacfwd(f)
    for _ in range(iters):
        err = f(q) - target
        J = jac(q)
        dq = torch.linalg.solve(J.T @ J + damping * eye, J.T @ err)
        q = q - torch.clamp(dq, -step_clip, step_clip)
    return q


def marker_positions(model: Model, q: torch.Tensor,
                     markers: Sequence[Tuple[int, torch.Tensor]]) -> torch.Tensor:
    """World positions of body-fixed markers, markers = [(body index, local
    offset (3,))]: (..., n_markers, 3)."""
    kin = dyn.forward_kinematics(model, q)
    return torch.stack([kin.T_wb[b].apply(off) for b, off in markers], dim=-2)
