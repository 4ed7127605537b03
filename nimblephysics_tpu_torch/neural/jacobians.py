"""Step Jacobian oracles: the reference's ``BackpropSnapshot`` by another name.

PyTorch counterpart of ``nimblephysics_tpu/neural/jacobians.py``. The six
Jacobians of the timestep (pos-pos, pos-vel, vel-pos, vel-vel, force-vel,
mass-vel) are slices of one ``torch.func.jacfwd`` through the
differentiable step, through the contact LCP by its implicit active-set
rule (``ops/lcp.py`` ``_ImplicitLCP``), and ``backprop_state`` pulls a loss
gradient on the next state back by ``torch.func.vjp``.

States carry leading batch dimensions. Over a batch the per-state
Jacobians come from ``torch.func.vmap`` over it, so a model with contact
slots solves all its LCPs in one call (K7 on the card: the LCP rule's
``vmap`` folds the batch in, and under ``jacfwd`` the directions meet only
the rule, never the solver).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops.contact import contact_step, lcp_dim, lcp_findex
from nimblephysics_tpu_torch.ops.frozen_contact import (
    FrozenClasses,
    frozen_contact_step,
    gov_matrix,
)
from nimblephysics_tpu_torch.simulation.step import step


class StepJacobians(NamedTuple):
    """The six Jacobians of (q', v') with respect to (q, v, tau, mass), each
    with the state's leading batch dimensions in front."""

    pos_pos: torch.Tensor    # dq'/dq   (..., nq, nq)
    pos_vel: torch.Tensor    # dv'/dq
    vel_pos: torch.Tensor    # dq'/dv
    vel_vel: torch.Tensor    # dv'/dv
    force_vel: torch.Tensor  # dv'/daction (..., nq, na)
    mass_vel: torch.Tensor   # dv'/dmass   (..., nq, nb)


def step_jacobians(model: Model, state: State, action: torch.Tensor) -> StepJacobians:
    """All six step Jacobians at (state, action) in one forward-mode sweep
    over (q, v, action, mass)."""

    def f(q, v, a, mass):
        s2 = step(model.replace(mass=mass), State(q, v), a)
        return s2.q, s2.v

    jac = torch.func.jacfwd(f, argnums=(0, 1, 2, 3))
    batch = state.q.shape[:-1]
    if batch:
        # the batch flattened to one vmapped dimension, the action broadcast
        # to it
        q, v = state.q.reshape(-1, model.nq), state.v.reshape(-1, model.nq)
        a = action.expand(batch + action.shape[-1:]).reshape(q.shape[0], -1)
        out = torch.func.vmap(jac, in_dims=(0, 0, 0, None))(q, v, a, model.mass)
        out = tuple(tuple(t.reshape(batch + t.shape[1:]) for t in row) for row in out)
    else:
        out = jac(state.q, state.v, action, model.mass)
    (dqdq, dqdv, _dqda, _dqdm), (dvdq, dvdv, dvda, dvdm) = out
    return StepJacobians(pos_pos=dqdq, pos_vel=dvdq, vel_pos=dqdv, vel_vel=dvdv,
                         force_vel=dvda, mass_vel=dvdm)


def backprop_state(
    model: Model, state: State, action: torch.Tensor, grad_next_state: torch.Tensor,
    explore_alternate_strategies: bool = False,
):
    """``BackpropSnapshot::backpropState``: pull a loss gradient on the next
    flat state (..., 2 nq) back to (the gradient on the current flat state,
    the gradient on the action).

    With ``explore_alternate_strategies`` (the reference's saddle-point
    escape): besides the correct gradient, take a second one through the
    frozen-class step under overridden classes (friction rows unclamped,
    each normal or limit row clamped iff J g_v' >= 0, the loss wanting its
    separating velocity decreased) and return, per state, whichever has
    the larger magnitude |g_v| + |g_action| / dt. The step's forward pass
    runs once (one LCP solve, K7 on the card); the second gradient solves
    no LCP."""
    x = state.flat()
    m = lcp_dim(model)
    if not explore_alternate_strategies or m == 0:
        def f(x_, a_):
            return step(model, State.from_flat(x_), a_).flat()

        _, vjp = torch.func.vjp(f, x, action)
        return vjp(grad_next_state)

    def f_info(x_, a_):
        s2, info = contact_step(model, State.from_flat(x_), model.action_to_tau(a_),
                                return_info=True)
        return s2.flat(), info.J

    _, vjp, J = torch.func.vjp(f_info, x, action, has_aux=True)
    gx, ga = vjp(grad_next_state)

    nq = model.nq
    dtype, device = grad_next_state.dtype, grad_next_state.device
    # the loss's gradient on the constraint-space velocities: J g_v'
    loss_wrt_contact_vels = (J @ grad_next_state[..., nq:, None])[..., 0]
    frictional = torch.as_tensor(np.asarray(lcp_findex(model)) >= 0, device=device)
    zero = torch.zeros_like(loss_wrt_contact_vels)
    # normal and limit rows: unclamped where the loss wants them to separate
    cmask = torch.where(frictional, zero,
                        torch.where(loss_wrt_contact_vels < 0, zero, zero + 1.0)).to(dtype)
    classes = FrozenClasses(cmask=cmask, us=torch.zeros_like(cmask))
    gov = torch.as_tensor(gov_matrix(model), dtype=dtype, device=device)

    def f_alt(x_, a_):
        return frozen_contact_step(model, State.from_flat(x_), model.action_to_tau(a_),
                                   classes, gov).flat()

    _, vjp_alt = torch.func.vjp(f_alt, x, action)
    gx2, ga2 = vjp_alt(grad_next_state)

    def mag(gx_, ga_):
        return (torch.linalg.vector_norm(gx_[..., nq:], dim=-1)
                + torch.linalg.vector_norm(ga_, dim=-1) / model.dt)

    better = (mag(gx2, ga2) > mag(gx, ga))[..., None]
    return torch.where(better, gx2, gx), torch.where(better, ga2, ga)
