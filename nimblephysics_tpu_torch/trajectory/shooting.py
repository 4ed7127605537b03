"""Single and multiple shooting trajectory optimization.

PyTorch counterpart of ``nimblephysics_tpu/trajectory/shooting.py`` (the
reference's ``SingleShot``, ``MultiShot`` and ``SGDOptimizer``):

  * ``SingleShootingProblem``: one rollout, the controls as decision
    variables, optionally the start state and static model leaves (masses)
    too, and bounded constraint LossFns handled by a PHR augmented
    Lagrangian;
  * ``MultipleShootingProblem``: the horizon in segments whose start
    states are decision variables, the knot defects equality constraints
    of an augmented Lagrangian.

The solvers run a fixed number of first-order iterations (``optax.adam`` /
``optax.sgd`` semantics, ``utils/optim.py``), each a rollout of the step
and its reverse pass. A constrained model's rollout solves its LCP in every
step (K7 on the card, once per step) and differentiates it by the implicit
rule. The segments of multiple shooting roll out together, as one leading
batch dimension of the step, so K7 runs once per step for all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from nimblephysics_tpu_torch._device import model_device
from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.simulation.step import rollout
from nimblephysics_tpu_torch.utils.optim import (
    adam_init,
    adam_update,
    apply_updates,
    global_norm,
    make_optimizer,
    value_and_grad,
)


class Trajectory(NamedTuple):
    """A rollout: the states after each step and the controls that made
    them."""

    q: torch.Tensor        # (T, nq)
    v: torch.Tensor        # (T, nq)
    u: torch.Tensor        # (T, na)


# A loss maps a Trajectory to a scalar tensor.
LossFn = Callable[[Trajectory], torch.Tensor]


def _actuated_bounds(model: Model):
    idx = list(model.actuated)
    return model.tau_lower[idx], model.tau_upper[idx]


@dataclasses.dataclass(frozen=True, eq=False)
class SingleShootingProblem:
    """Decision variables: the control sequence, and

      * ``static_vars``: names of Model leaves optimized as static decision
        variables over the horizon ("mass": system identification inside
        the trajectory optimization);
      * ``tune_start``: the start state too;
      * ``constraints``: (LossFn, lo, hi) triples, bounded constraints
        enforced by an augmented-Lagrangian outer loop.
    """

    model: Model
    x0: State
    horizon: int
    loss: LossFn
    tune_start: bool = False
    static_vars: tuple = ()
    constraints: tuple = ()   # ((LossFn, lo, hi), ...)

    def rollout_controls(self, u: torch.Tensor) -> Trajectory:
        _, traj = rollout(self.model, self.x0, u)
        return Trajectory(q=traj.q, v=traj.v, u=u)

    def objective(self, u: torch.Tensor) -> torch.Tensor:
        return self.loss(self.rollout_controls(u))

    def initial_params(self, u_init: torch.Tensor) -> dict:
        p = {"u": u_init}
        if self.tune_start:
            p["x0q"] = self.x0.q
            p["x0v"] = self.x0.v
        for name in self.static_vars:
            p[name] = getattr(self.model, name)
        return p

    def build(self, params: dict):
        """(model, x0) with the decision variables substituted in."""
        model = self.model
        if self.static_vars:
            model = model.replace(**{n: params[n] for n in self.static_vars})
        x0 = State(q=params["x0q"], v=params["x0v"]) if self.tune_start else self.x0
        return model, x0

    def rollout_params(self, params: dict) -> Trajectory:
        model, x0 = self.build(params)
        _, traj = rollout(model, x0, params["u"])
        return Trajectory(q=traj.q, v=traj.v, u=params["u"])


class ShootingSolution(NamedTuple):
    u: torch.Tensor                 # optimized controls (T, na)
    loss: torch.Tensor              # final loss
    loss_history: torch.Tensor      # (iters,) the loss before each update
    params: Optional[dict] = None   # every decision variable ("x0q"/"x0v",
    #   static leaves under their names), for the generalized problem
    constraint_values: Optional[torch.Tensor] = None  # (n_constraints,)


def _clip_grads(g: dict, grad_clip: float) -> dict:
    """Global-norm clip, then non-finite entries zeroed (the JAX package's
    generalized-problem form)."""
    scale = torch.clamp(grad_clip / torch.clamp(global_norm(g), min=1e-12), max=1.0)
    return {k: torch.where(torch.isfinite(x), x * scale, torch.zeros_like(x))
            for k, x in g.items()}


def solve_single_shooting(
    problem: SingleShootingProblem,
    u_init: Optional[torch.Tensor] = None,
    iters: int = 200,
    optimizer: str = "adam",
    lr: float = 1e-1,
    u_clip: bool = True,
    grad_clip: Optional[float] = None,
    device="cuda",
) -> ShootingSolution:
    """A fixed number of first-order iterations on the shooting problem.

    optimizer: "sgd" (plain gradient descent, the reference's
    SGDOptimizer) or "adam". u_clip: project the controls onto the
    actuated dofs' torque limits after each update. grad_clip: a
    global-norm gradient clip with a non-finite guard, the valve for LCP
    derivative spikes near degenerate contact. With static variables, a
    tuned start or constraints, the PHR augmented Lagrangian runs 6 outer
    rounds when there are constraints (mu from 10, doubling), each
    ``iters // 6`` inner iterations from a fresh optimizer state, and a
    "mass" variable is floored at 1e-6. ``device`` is where the solve
    runs, "cuda" by default; the problem's model must lie there."""
    model = problem.model
    model_device("solve_single_shooting: the model", model, device)
    na = model.num_actions
    dtype = model.dtype
    if u_init is None:
        u_init = torch.zeros((problem.horizon, na), dtype=dtype, device=model.device)
    lo, hi = _actuated_bounds(model) if na else (None, None)

    def project(u):
        return torch.minimum(torch.maximum(u, lo), hi) if (u_clip and na) else u

    opt_init, opt_update = make_optimizer(optimizer, lr)

    extended = problem.tune_start or problem.static_vars or problem.constraints
    if not extended:
        u = project(u_init)
        opt_state = opt_init({"u": u_init})
        hist = []
        for _ in range(iters):
            val, g = value_and_grad(lambda p: problem.objective(p["u"]), {"u": u})
            if grad_clip is not None:
                # the JAX package's plain form, not _clip_grads: the guard
                # after the scale zeroes every entry when the norm is not
                # finite, where _clip_grads would leave the finite ones NaN
                gu = g["u"]
                gn = torch.sqrt(torch.sum(gu * gu))
                gu = gu * torch.clamp(grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
                # a non-finite gradient must not poison the iterate
                g = {"u": torch.where(torch.isfinite(gu), gu, torch.zeros_like(gu))}
            updates, opt_state = opt_update(g, opt_state)
            u = project(apply_updates({"u": u}, updates)["u"])
            hist.append(val)
        with torch.no_grad():
            final = problem.objective(u)
        return ShootingSolution(u=u, loss=final, loss_history=torch.stack(hist))

    # the generalized decision vector and the augmented-Lagrangian constraints
    ncon = len(problem.constraints)
    dev = model.device
    c_lo = torch.tensor([c[1] for c in problem.constraints], dtype=dtype, device=dev)
    c_hi = torch.tensor([c[2] for c in problem.constraints], dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def con_values(params):
        traj = problem.rollout_params(params)
        return torch.stack([fn(traj) for fn, _, _ in problem.constraints])

    def al_objective(params, lam_lo, lam_hi, mu):
        traj = problem.rollout_params(params)
        val = problem.loss(traj)
        if ncon:
            g = torch.stack([fn(traj) for fn, _, _ in problem.constraints])
            # PHR augmented Lagrangian for g in [lo, hi]
            t_hi = torch.maximum(zero, lam_hi + mu * (g - c_hi))
            t_lo = torch.maximum(zero, lam_lo + mu * (c_lo - g))
            val = val + torch.sum(t_hi**2 - lam_hi**2 + t_lo**2 - lam_lo**2) / (2.0 * mu)
        return val

    def project_params(p):
        p = dict(p)
        p["u"] = project(p["u"])
        if "mass" in p:  # physical positivity
            p["mass"] = torch.maximum(p["mass"], p["mass"].new_tensor(1e-6))
        return p

    params = project_params(problem.initial_params(u_init))
    lam_lo = torch.zeros((ncon,), dtype=dtype, device=dev)
    lam_hi = torch.zeros_like(lam_lo)
    outer = 6 if ncon else 1
    inner_iters = max(1, iters // outer)
    mu = 10.0
    hist = []
    for _ in range(outer):
        opt_state = opt_init(params)
        for _ in range(inner_iters):
            val, g = value_and_grad(lambda p: al_objective(p, lam_lo, lam_hi, mu), params)
            if grad_clip is not None:
                g = _clip_grads(g, grad_clip)
            updates, opt_state = opt_update(g, opt_state)
            params = project_params(apply_updates(params, updates))
            hist.append(val)
        if ncon:
            with torch.no_grad():
                g = con_values(params)
            lam_hi = torch.maximum(zero, lam_hi + mu * (g - c_hi))
            lam_lo = torch.maximum(zero, lam_lo + mu * (c_lo - g))
            mu = mu * 2.0
    with torch.no_grad():
        traj = problem.rollout_params(params)
        final_loss = problem.loss(traj)
        cvals = torch.stack([fn(traj) for fn, _, _ in problem.constraints]) if ncon else None
    return ShootingSolution(u=params["u"], loss=final_loss, loss_history=torch.stack(hist),
                            params=params, constraint_values=cvals)


@dataclasses.dataclass(frozen=True, eq=False)
class MultipleShootingProblem:
    """The horizon split into ``num_segments`` segments of ``seg_len``
    steps. Decision variables: each segment's start state (but segment 0's,
    pinned to x0) and all the controls; the knot defects x_end(s) -
    x_start(s + 1) are equality constraints."""

    model: Model
    x0: State
    num_segments: int
    seg_len: int
    loss: LossFn

    @property
    def horizon(self) -> int:
        return self.num_segments * self.seg_len

    def segment_rollouts(self, starts_q, starts_v, u):
        """Roll every segment at once, the segments a leading batch
        dimension of the step. starts_q / starts_v (S, nq), row 0 x0; u (S,
        L, na). Returns the segments' states (S, L, nq) and their end states
        (S, nq)."""
        final, traj = rollout(self.model, State(starts_q, starts_v), u)
        return traj.q, traj.v, final.q, final.v

    def defects(self, starts_q, starts_v, fq, fv):
        """(S - 1, 2 nq) knot defects."""
        return torch.cat([fq[:-1] - starts_q[1:], fv[:-1] - starts_v[1:]], dim=-1)


class MultiShootingSolution(NamedTuple):
    u: torch.Tensor            # (T, na) the controls, segments concatenated
    starts_q: torch.Tensor     # (S, nq)
    starts_v: torch.Tensor
    loss: torch.Tensor
    defect_norm: torch.Tensor
    loss_history: torch.Tensor


def solve_multiple_shooting(
    problem: MultipleShootingProblem,
    u_init: Optional[torch.Tensor] = None,
    outer_iters: int = 8,
    inner_iters: int = 300,
    lr: float = 1e-2,
    mu0: float = 50.0,
    mu_growth: float = 2.0,
    device="cuda",
) -> MultiShootingSolution:
    """Augmented-Lagrangian multiple shooting: ``outer_iters`` rounds of
    ``inner_iters`` Adam steps over (segment start states, controls), each
    round from a fresh Adam state, then lambda <- lambda + mu c and mu <-
    mu mu_growth. The segment starts begin on one chained rollout of
    ``u_init``. ``device`` as ``solve_single_shooting``'s."""
    model = problem.model
    model_device("solve_multiple_shooting: the model", model, device)
    S, L, na = problem.num_segments, problem.seg_len, model.num_actions
    nq = model.nq
    dtype, dev = model.dtype, model.device
    if u_init is None:
        u_init = torch.zeros((S, L, na), dtype=dtype, device=dev)
    else:
        u_init = u_init.reshape(S, L, na)

    # the segment starts along one chained rollout of u_init
    starts_q0, starts_v0 = [], []
    with torch.no_grad():
        s = problem.x0
        for k in range(S):
            starts_q0.append(s.q)
            starts_v0.append(s.v)
            s, _ = rollout(model, s, u_init[k])
    lam0 = torch.zeros((S - 1, 2 * nq), dtype=dtype, device=dev)
    lo, hi = _actuated_bounds(model)
    x0q, x0v = problem.x0.q[None], problem.x0.v[None]

    def full_loss(params, lam, mu):
        starts_q = torch.cat([x0q, params["sq"]], dim=0)
        starts_v = torch.cat([x0v, params["sv"]], dim=0)
        u = params["u"]
        qs, vs, fq, fv = problem.segment_rollouts(starts_q, starts_v, u)
        traj = Trajectory(q=qs.reshape(S * L, nq), v=vs.reshape(S * L, nq),
                          u=u.reshape(S * L, na))
        c = problem.defects(starts_q, starts_v, fq, fv)
        al = torch.sum(lam * c) + 0.5 * mu * torch.sum(c * c)
        return problem.loss(traj) + al, c

    params = dict(u=u_init, sq=torch.stack(starts_q0[1:]), sv=torch.stack(starts_v0[1:]))
    lam, mu = lam0, mu0
    hist = []
    for _ in range(outer_iters):
        opt_state = adam_init(params)
        for _ in range(inner_iters):
            (val, _), g = value_and_grad(lambda p: full_loss(p, lam, mu), params)
            updates, opt_state = adam_update(g, opt_state, lr)
            params = apply_updates(params, updates)
            params["u"] = torch.minimum(torch.maximum(params["u"], lo), hi)
            hist.append(val)
        with torch.no_grad():
            _, c = full_loss(params, lam, mu)
        lam = lam + mu * c
        mu = mu * mu_growth

    with torch.no_grad():
        final_val, c = full_loss(params, torch.zeros_like(lam0), 0.0)
    return MultiShootingSolution(
        u=params["u"].reshape(S * L, na),
        starts_q=torch.cat([x0q, params["sq"]], dim=0),
        starts_v=torch.cat([x0v, params["sv"]], dim=0),
        loss=final_val,
        defect_norm=torch.linalg.vector_norm(c),
        loss_history=torch.stack(hist),
    )
