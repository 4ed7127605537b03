"""Constraint-row counting for the step's dispatch.

PyTorch counterpart of ``lcp_dim`` and the counters it needs in
``nimblephysics_tpu/ops/contact.py``. The port's models carry no collision
shapes, servos, mimic couplings or loop closures yet, so the LCP rows come
from joint position limits and Coulomb joint friction alone. The
constrained step itself (``contact_step``) is ROADMAP M4.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nimblephysics_tpu_torch.models.model import Model


def limited_dofs(model: Model) -> Tuple[int, ...]:
    """Dofs with any finite position limit."""
    lo = model.q_lower.detach().cpu().numpy()
    hi = model.q_upper.detach().cpu().numpy()
    return tuple(int(d) for d in range(model.nq)
                 if np.isfinite(lo[d]) or np.isfinite(hi[d]))


def coulomb_dofs(model: Model) -> Tuple[int, ...]:
    """Dofs with static Coulomb joint friction."""
    cf = model.coulomb_friction.detach().cpu().numpy()
    return tuple(int(d) for d in range(model.nq) if cf[d] > 0.0)


def lcp_dim(model: Model) -> int:
    return 2 * len(limited_dofs(model)) + len(coulomb_dofs(model))


def contact_step(model: Model, state, tau):
    raise NotImplementedError(
        "the constrained step (joint limits, Coulomb friction, contact) is "
        "not ported yet (ROADMAP queue A, M4); plan on relax_limits(model)"
    )
