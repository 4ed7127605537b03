"""The timestep: contact-free, or constrained through ops/contact.py.

PyTorch counterpart of ``nimblephysics_tpu/simulation/step.py``:

    qdd    = ABA(q_t, v_t, tau)
    v_t+1  = v_t + dt qdd
    q_t+1  = integrate(q_t, v_t)    (pre-step velocity)

States carry leading batch dimensions. A model with constraint rows
(joint limits, Coulomb friction) dispatches to ``ops/contact.contact_step``,
differentiable forward and reverse (``torch.func`` included) through the
boxed LCP's implicit active-set rule.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.ops import joints as J
from nimblephysics_tpu_torch.ops.contact import contact_step, lcp_dim
from nimblephysics_tpu_torch.ops.lie import Transform


def integrate_positions(model: Model, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-joint explicit position integration with pre-step velocities."""
    parts = []
    for i, jt in enumerate(model.joint_types):
        sl = model.joint_slice(i)
        if sl.stop == sl.start:
            continue
        T_cj = Transform(model.T_cj.R[i], model.T_cj.p[i])
        parts.append(J.integrate_position(jt, q[..., sl], v[..., sl], model.dt,
                                          model.axes[i], T_cj))
    return torch.cat(parts, dim=-1) if parts else q


def forward_step(model: Model, state: State, tau: torch.Tensor) -> State:
    """One contact-free semi-implicit Euler step."""
    qdd = dyn.aba(model, state.q, state.v, tau)
    v_next = state.v + model.dt * qdd
    q_next = integrate_positions(model, state.q, state.v)
    return State(q=q_next, v=v_next)


def step(model: Model, state: State, action: torch.Tensor) -> State:
    """RL-style step: ``action`` (..., na) drives the actuated dofs."""
    tau = model.action_to_tau(action)
    if lcp_dim(model) > 0:
        return contact_step(model, state, tau)
    return forward_step(model, state, tau)


def rollout(model: Model, state0: State, actions: torch.Tensor) -> Tuple[State, State]:
    """Roll a horizon of actions (..., T, na) forward from state0 (..., nq).

    Returns (final state, trajectory) with the trajectory's time axis just
    before the dof axis, (..., T, nq). A constrained model takes
    ``contact_step`` with the previous step's impulses as its warm start."""
    m = lcp_dim(model)
    s = state0
    x_prev = None
    qs, vs = [], []
    for t in range(actions.shape[-2]):
        tau = model.action_to_tau(actions[..., t, :])
        if m:
            s, info = contact_step(model, s, tau, x_warm=x_prev, return_info=True)
            x_prev = info.impulses
        else:
            s = forward_step(model, s, tau)
        qs.append(s.q)
        vs.append(s.v)
    return s, State(q=torch.stack(qs, dim=-2), v=torch.stack(vs, dim=-2))
