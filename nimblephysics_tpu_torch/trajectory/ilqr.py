"""iLQR for the MPC layer: the batched replan, contact-free or on frozen
contact classes, and the contact-MPC loop around it.

PyTorch counterpart of ``nimblephysics_tpu/trajectory/ilqr.py``:

  * ``ilqr_solve``: one world, the sequential Riccati recursion with Tassa
    regularisation, the alpha ladder and the reg schedule — the plain
    end-to-end reference, with no kernel.
  * ``ilqr_solve_batch``: B worlds at once, the same iteration as
    ``vmap(ilqr_solve)``, with kernels where the JAX package runs its
    Pallas kernels: linearize (K3; on frozen classes K5 where the JAX
    package's "auto" takes it, else K4; "jvp" K4 at the frozen solve's
    default depth, as ``linearize_pallas(classes=)``; "chain" K5 through
    ``ops/lane_chain.py``), the Riccati backward (K1) and the line-search
    rollout (K2), the last also for the first open-loop rollout. A model
    with constraint rows and no classes takes the JAX package's unfused
    branch on the full constrained step: rollouts of the step (its LCPs
    on K7 for a model with contact slots), jacfwd of the step chunked over
    time, K1.
  * ``solve_contact_mpc`` (one world, plain) and ``solve_contact_mpc_batch``:
    the per-step LCP classes come from one full-LCP rollout
    (``class_refresh="rollout"``, K6 in the batch) or from the pointwise
    fixed point (``"pointwise"``: a frozen-class rollout on K2, then every
    (world, step) point classified by its own LCP, K7 in the batch); iLQR
    runs on the smooth frozen-class dynamics, and the winning trajectory is
    classified again pointwise for the next replan's warm start.

The cost derivatives (lx, lu, lxx, luu, lux, Vx_T, Vxx_T) come from
``torch.func`` outside any kernel. Forward-only, like the JAX solver's
batched path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import frozen_contact
from nimblephysics_tpu_torch.ops.contact import contact_step, lcp_dim
from nimblephysics_tpu_torch.ops.cuda_linearize import (
    dyn_for_trace,
    dyn_frozen_for_trace,
    linear_position_update,
    linearize,
    linearize_plain,
    linearize_split,
    linearize_split_plain,
    linearize_vjp,
    linearize_vjp_plain,
)
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward, riccati_backward_plain
from nimblephysics_tpu_torch.ops.cuda_rollout import (
    rollout_classes,
    rollout_classes_plain,
    rollout_gains,
    rollout_gains_plain,
)
from nimblephysics_tpu_torch.ops.frozen_contact import FrozenClasses
from nimblephysics_tpu_torch.ops.lane_chain import (
    chained_linearize_vjp,
    chained_linearize_vjp_plain,
)
from nimblephysics_tpu_torch.ops.linalg_small import inv_spd_pivots
from nimblephysics_tpu_torch.simulation.step import rollout as full_rollout


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iters: int = 20
    reg_init: float = 1e-3
    reg_min: float = 1e-8
    reg_max: float = 1e8
    reg_up: float = 8.0
    reg_down: float = 0.5
    alphas: tuple = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01)
    # backward pass: "sequential" only; "parallel" (the associative-scan
    # LQR of the JAX package) is not ported yet
    riccati: str = "sequential"
    # linearize sweep of ilqr_solve_batch: K3 on the contact-free step
    # whatever the mode; on frozen classes "split" takes K4, "vjp" K5, and
    # "auto" K5 where every joint integrates linearly and nq >= 4, else K4
    # (the JAX package's rule); "jvp" K4 at the frozen solve's default PCG
    # depth m + 6 whatever planner_cg_iters is (linearize_pallas(classes=)
    # takes no depth); "chain" K5 (the JAX package's chained row-VJP);
    # "xla" is not ported yet
    linearize: str = "auto"
    # PCG depth of the frozen-class solve in the planner (K2, K4, K5); None
    # is m + 6
    planner_cg_iters: Optional[int] = None
    # line-search rollout of ilqr_solve_batch: "auto" (K2) only; "xla" is
    # not ported
    rollout: str = "auto"
    # ilqr_solve_batch: False runs the plain PyTorch versions of the
    # kernels on any device (what the kernels are held against); True runs
    # the kernels on CUDA tensors (the plain versions on CPU tensors)
    kernels: bool = True


class ILQRSolution(NamedTuple):
    u: torch.Tensor             # (..., T, na)
    x: torch.Tensor             # (..., T+1, nx) state trajectory
    cost: torch.Tensor          # (...,)
    cost_history: torch.Tensor  # (iters, ...)
    K: torch.Tensor             # (..., T, na, nx) feedback gains
    k: torch.Tensor             # (..., T, na) feedforward terms


def _check(model: Model, config: ILQRConfig, classes, dtype, device):
    """Validate the call; returns the classes as a (cmask, us) pair of
    contiguous tensors, or None for the contact-free dynamics."""
    if config.riccati != "sequential":
        raise NotImplementedError(
            f"riccati={config.riccati!r} is not ported yet (ROADMAP queue A, M3)")
    if config.linearize not in ("auto", "split", "vjp", "jvp", "chain"):
        raise NotImplementedError(
            f"linearize={config.linearize!r} is not ported yet (ROADMAP queue A, "
            "M2/M3/M5 leftovers: the plain versions under kernels=False)")
    if config.rollout != "auto":
        raise NotImplementedError(
            f"rollout={config.rollout!r} is not ported yet (ROADMAP queue A, "
            "M2/M3/M5 leftovers: the plain versions under kernels=False)")
    if config.iters < 1:
        raise ValueError("iters must be at least 1")
    if model.device != device or model.dtype != dtype:
        raise ValueError(f"model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {device}")
    if classes is None or lcp_dim(model) == 0:
        # the frozen-class step of a model without rows is the contact-free step
        return None
    return tuple(c.contiguous() for c in classes)


def _full_step_dyn(model: Model, kernels: bool):
    """The full constrained step x' = f(x, u), the LCP solved in every step
    and differentiated by its implicit rule (the JAX package's ``_make_dyn``
    of a model with rows): K7 for a model with contact slots on CUDA
    tensors when ``kernels``, the direct solve (plain) for a limits-only
    model."""

    def dyn(x, u):
        return contact_step(model, State.from_flat(x), model.action_to_tau(u),
                            kernels=kernels).flat()

    return dyn


def _full_step_fns(model: Model, running_cost, final_cost, kernels: bool):
    """(linearize, rollout) of ``ilqr_solve_batch`` on the full constrained
    step, the JAX package's unfused branch: fx, fu by jacfwd of the step,
    chunked over time (Tc = max(1, min(T, 16384 // B)) steps per chunk, 1
    when Tc does not divide T), each chunk one vmap over its B Tc points, so
    the LCPs of a chunk are solved in one batch and only the implicit rule
    sees the tangent directions; the line search's alphas folded into the
    batch, so each time step solves A B LCPs at once. The costs are the
    callables."""
    dyn = _full_step_dyn(model, kernels)
    jac = vmap(jacfwd(dyn, argnums=(0, 1)))
    clamp = _controls_clamp(model)

    def lin(model_, xs, u):
        B, T, nx = xs.shape
        na = u.shape[-1]
        Tc = max(1, min(T, 16384 // max(B, 1)))
        if T % Tc != 0:
            Tc = 1
        fx, fu = [], []
        for c in range(0, T, Tc):
            a, b = jac(xs[:, c:c + Tc].reshape(B * Tc, nx), u[:, c:c + Tc].reshape(B * Tc, na))
            fx.append(a.reshape(B, Tc, nx, nx))
            fu.append(b.reshape(B, Tc, nx, na))
        return torch.cat(fx, 1), torch.cat(fu, 1)

    def roll(model_, running_cost_, final_cost_, x0_flat, xs_ref, u_ref, K, k, alphas):
        A = alphas.shape[0]
        B, T, na = u_ref.shape
        nx = x0_flat.shape[-1]
        al = alphas[:, None, None]
        x = x0_flat.expand(A, B, nx)
        xs, us = [x], []
        for t in range(T):
            du = (K[:, t] @ (x - xs_ref[:, t])[..., None])[..., 0]
            u_t = clamp(u_ref[:, t] + al * k[:, t] + du)
            x = dyn(x.reshape(A * B, nx), u_t.reshape(A * B, na)).reshape(A, B, nx)
            xs.append(x)
            us.append(u_t)
        xss, uss = torch.stack(xs, 2), torch.stack(us, 2)
        ts = torch.arange(T, device=u_ref.device).repeat(A * B)
        run = vmap(running_cost)(xss[:, :, :-1].reshape(A * B * T, nx),
                                 uss.reshape(A * B * T, na), ts)
        costs = run.reshape(A, B, T).sum(-1) + vmap(final_cost)(xss[:, :, -1].reshape(A * B, nx)
                                                                ).reshape(A, B)
        return xss, uss, costs

    return lin, roll


def _controls_clamp(model: Model):
    act = list(model.actuated)
    lo, hi = model.tau_lower[act], model.tau_upper[act]
    return lambda u: torch.clamp(u, lo, hi)


def _cost_derivatives(running_cost, final_cost, xs, u):
    """lx, lu, lxx, luu, lux at every (world, step) point and Vx_T, Vxx_T at
    the final states, by torch.func over the per-point cost callables."""
    B, T, na = u.shape
    nx = xs.shape[-1]
    x_pts = xs[:, :-1].reshape(B * T, nx)
    u_pts = u.reshape(B * T, na)
    t_pts = torch.arange(T, device=u.device).repeat(B)
    lx, lu = vmap(grad(running_cost, argnums=(0, 1)))(x_pts, u_pts, t_pts)
    lxx = vmap(hessian(running_cost, argnums=0))(x_pts, u_pts, t_pts)
    luu = vmap(hessian(running_cost, argnums=1))(x_pts, u_pts, t_pts)
    lux = vmap(jacfwd(grad(running_cost, argnums=1), argnums=0))(x_pts, u_pts, t_pts)
    Vx_T = vmap(grad(final_cost))(xs[:, -1])
    Vxx_T = vmap(hessian(final_cost))(xs[:, -1])
    return (lx.reshape(B, T, nx), lu.reshape(B, T, na),
            lxx.reshape(B, T, nx, nx), luu.reshape(B, T, na, na),
            lux.reshape(B, T, na, nx), Vx_T.contiguous(), Vxx_T.contiguous())


def ilqr_solve_batch(
    model: Model,
    x0_flat: torch.Tensor,       # (B, nx)
    u_init: torch.Tensor,        # (B, T, na)
    running_cost: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    final_cost: Callable[[torch.Tensor], torch.Tensor],
    config: ILQRConfig = ILQRConfig(),
    classes=None,
) -> ILQRSolution:
    """Batched iLQR: semantically ``vmap(ilqr_solve)``, with the linearize,
    Riccati and rollout kernels on CUDA tensors (``config.kernels``).

    ``running_cost(x, u, t)`` and ``final_cost(x)`` act on one point; on the
    card, where K2 runs the line search, they must be a QuadraticCost and a
    QuadraticFinalCost. ``classes`` (a FrozenClasses or (cmask, us) pair,
    each (B, T, m)): solve on the frozen-class contact dynamics. A model
    with constraint rows and no classes is solved on the full constrained
    step (``_full_step_fns``: K7 and K1 on the card, ``linearize``,
    ``planner_cg_iters`` and ``rollout`` unused, as in the JAX package)."""
    B, T, na = u_init.shape
    dtype, device = u_init.dtype, u_init.device
    cl = _check(model, config, classes, dtype, device)
    full = cl is None and lcp_dim(model) > 0
    nx = x0_flat.shape[-1]
    cg = config.planner_cg_iters
    mode = config.linearize
    if mode == "auto":
        mode = "vjp" if linear_position_update(model) and model.nq >= 4 else "split"
    if config.kernels:
        lin_free, ric, roll_fn = linearize, riccati_backward, rollout_gains
        lin_frozen = {"split": linearize_split, "vjp": linearize_vjp,
                      "chain": lambda model, xs, u, cl, cg: chained_linearize_vjp(
                          model, xs, u, cl, cg_iters=cg),
                      "jvp": lambda model, xs, u, cl, cg: linearize(model, xs, u, classes=cl)}
    else:
        lin_free, ric, roll_fn = linearize_plain, riccati_backward_plain, rollout_gains_plain
        lin_frozen = {"split": linearize_split_plain, "vjp": linearize_vjp_plain,
                      "chain": chained_linearize_vjp_plain,
                      "jvp": lambda model, xs, u, cl, cg: linearize_split_plain(
                          model, xs, u, cl)}

    if full:
        lin, roll = _full_step_fns(model, running_cost, final_cost, config.kernels)
    else:
        def lin(model, xs, u):
            if cl is None:
                return lin_free(model, xs, u)
            return lin_frozen[mode](model, xs, u, cl, cg)

        def roll(*args):
            return roll_fn(*args, classes=cl, cg_iters=cg)

    clamp = _controls_clamp(model)
    x0_flat = x0_flat.contiguous()
    alphas = torch.tensor(config.alphas, dtype=dtype, device=device)

    u = clamp(u_init).contiguous()
    # the first open-loop rollout is the gain rollout with zero gains
    xss0, _, costs0 = roll(
        model, running_cost, final_cost, x0_flat, u.new_zeros(B, T + 1, nx), u,
        u.new_zeros(B, T, na, nx), u.new_zeros(B, T, na), alphas.new_ones(1))
    xs, cost = xss0[0], costs0[0]
    reg = torch.full((B,), config.reg_init, dtype=dtype, device=device)
    barange = torch.arange(B, device=device)
    hist = []
    for _ in range(config.iters):
        fx, fu = lin(model, xs[:, :-1].contiguous(), u)
        derivs = _cost_derivatives(running_cost, final_cost, xs, u)
        K, k, _, pd_ok = ric(fx, fu, *derivs, reg)
        xss, uss, costs = roll(model, running_cost, final_cost, x0_flat, xs, u,
                               K, k, alphas)
        best = torch.argmin(costs, dim=0)
        new_cost = costs[best, barange]
        improved = (new_cost < cost) & pd_ok
        xs = torch.where(improved[:, None, None], xss[best, barange], xs).contiguous()
        u = torch.where(improved[:, None, None], uss[best, barange], u).contiguous()
        cost = torch.where(improved, new_cost, cost)
        reg = torch.where(improved, (reg * config.reg_down).clamp(min=config.reg_min),
                          (reg * config.reg_up).clamp(max=config.reg_max))
        hist.append(cost)
    return ILQRSolution(u=u, x=xs, cost=cost, cost_history=torch.stack(hist),
                        K=K, k=k)


def ilqr_solve(
    model: Model,
    x0: State,
    u_init: torch.Tensor,        # (T, na)
    running_cost: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    final_cost: Callable[[torch.Tensor], torch.Tensor],
    config: ILQRConfig = ILQRConfig(),
    classes=None,
) -> ILQRSolution:
    """Minimize sum_t running_cost(x_t, u_t, t) + final_cost(x_T) for one
    world: the plain end-to-end reference (sequential Riccati recursion with
    Tassa regularisation Vxx + reg I inside the fu products).

    ``classes`` (a FrozenClasses or (cmask, us) pair, each (T, m)): solve on
    the frozen-class contact dynamics (the solve's default PCG depth, as
    the JAX package's ``ilqr_solve``); without them a model with constraint
    rows is solved on the full constrained step (K7 on CUDA tensors with
    ``config.kernels`` for a model with contact slots)."""
    T, na = u_init.shape
    dtype, device = u_init.dtype, u_init.device
    cl = _check(model, config, classes, dtype, device)
    if cl is None:
        step_free = (_full_step_dyn(model, config.kernels) if lcp_dim(model) > 0
                     else dyn_for_trace(model))

        def dyn(x, u, cl_t):
            return step_free(x, u)

        cl = (u_init.new_zeros((T, 0)),) * 2
    else:
        step_frozen = dyn_frozen_for_trace(model)

        def dyn(x, u, cl_t):
            return step_frozen(x, u, cl_t[0], cl_t[1])
    clamp = _controls_clamp(model)
    xflat0 = x0.flat()
    nx = xflat0.shape[-1]
    ts = torch.arange(T, device=device)
    eye = torch.eye(nx, dtype=dtype, device=device)

    def rollout_controls(u):
        xs = [xflat0]
        for t in range(T):
            xs.append(dyn(xs[-1], u[t], (cl[0][t], cl[1][t])))
        return torch.stack(xs)

    def traj_cost(xs, u):
        return vmap(running_cost)(xs[:-1], u, ts).sum() + final_cost(xs[-1])

    def rollout_with_gains(xs_ref, u_ref, K, k, alpha):
        x, xs, us = xflat0, [xflat0], []
        for t in range(T):
            u_t = clamp(u_ref[t] + alpha * k[t] + K[t] @ (x - xs_ref[t]))
            x = dyn(x, u_t, (cl[0][t], cl[1][t]))
            xs.append(x)
            us.append(u_t)
        return torch.stack(xs), torch.stack(us)

    dyn_jac = vmap(jacfwd(dyn, argnums=(0, 1)))

    def backward(xs, u, reg):
        fx, fu = dyn_jac(xs[:-1], u, cl)
        lx, lu = vmap(grad(running_cost, argnums=(0, 1)))(xs[:-1], u, ts)
        lxx = vmap(hessian(running_cost, argnums=0))(xs[:-1], u, ts)
        luu = vmap(hessian(running_cost, argnums=1))(xs[:-1], u, ts)
        lux = vmap(jacfwd(grad(running_cost, argnums=1), argnums=0))(xs[:-1], u, ts)
        Vx, Vxx = grad(final_cost)(xs[-1]), hessian(final_cost)(xs[-1])
        Ks, ks, ok = [None] * T, [None] * T, True
        for t in reversed(range(T)):
            Qx = lx[t] + fx[t].T @ Vx
            Qu = lu[t] + fu[t].T @ Vx
            Qxx = lxx[t] + fx[t].T @ Vxx @ fx[t]
            Quu = luu[t] + fu[t].T @ Vxx @ fu[t]
            Qux = lux[t] + fu[t].T @ Vxx @ fx[t]
            Vxx_reg = Vxx + reg * eye
            Quu_reg = luu[t] + fu[t].T @ Vxx_reg @ fu[t]
            Qux_reg = lux[t] + fu[t].T @ Vxx_reg @ fx[t]
            Quu_inv, min_piv = inv_spd_pivots(Quu_reg)
            ok = ok & bool(torch.isfinite(min_piv) & (min_piv > 0.0))
            k_t = -(Quu_inv @ Qu)
            K_t = -(Quu_inv @ Qux_reg)
            Vx = Qx + K_t.T @ Quu @ k_t + K_t.T @ Qu + Qux.T @ k_t
            Vxx = Qxx + K_t.T @ Quu @ K_t + K_t.T @ Qux + Qux.T @ K_t
            Vxx = 0.5 * (Vxx + Vxx.T)
            Ks[t], ks[t] = K_t, k_t
        return torch.stack(Ks), torch.stack(ks), ok

    u = clamp(u_init)
    xs = rollout_controls(u)
    cost = traj_cost(xs, u)
    reg = config.reg_init
    hist = []
    for _ in range(config.iters):
        K, k, pd_ok = backward(xs, u, reg)
        cands = [rollout_with_gains(xs, u, K, k, a) for a in config.alphas]
        costs = torch.stack([traj_cost(x2, u2) for x2, u2 in cands])
        best = int(torch.argmin(costs))
        improved = bool(costs[best] < cost) and pd_ok
        if improved:
            xs, u, cost = cands[best][0], cands[best][1], costs[best]
            reg = max(reg * config.reg_down, config.reg_min)
        else:
            reg = min(reg * config.reg_up, config.reg_max)
        hist.append(cost)
    return ILQRSolution(u=u, x=xs, cost=cost, cost_history=torch.stack(hist),
                        K=K, k=k)


def solve_contact_mpc(
    model: Model,
    x0: State,
    u_init: torch.Tensor,        # (T, na)
    running_cost: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    final_cost: Callable[[torch.Tensor], torch.Tensor],
    config: ILQRConfig = ILQRConfig(),
    outer_iters: int = 2,
    classes=None,
):
    """Contact-model iLQR on frozen mode sequences for one world, the plain
    reference: alternate {one full-LCP rollout recording the per-step LCP
    classes} with {iLQR on the frozen-class dynamics}. ``classes`` seeds the
    first inner solve (None: from ``u_init``'s rollout).

    Returns (ILQRSolution with x and cost evaluated on the true constrained
    dynamics, the final FrozenClasses for the next replan's warm start)."""
    ts = torch.arange(u_init.shape[0], device=u_init.device)
    u, sol = u_init, None
    for _ in range(outer_iters):
        if classes is None or sol is not None:
            _, _, classes, _ = frozen_contact.rollout_classes(model, x0, u)
        sol = ilqr_solve(model, x0, u, running_cost, final_cost, config, classes)
        u = sol.u
    _, traj = full_rollout(model, x0, u)
    xs_true = torch.cat([x0.flat()[None], traj.flat()], dim=0)
    cost_true = vmap(running_cost)(xs_true[:-1], u, ts).sum() + final_cost(xs_true[-1])
    _, _, classes_out, _ = frozen_contact.rollout_classes(model, x0, u)
    return sol._replace(x=xs_true, cost=cost_true), classes_out


def solve_contact_mpc_batch(
    model: Model,
    x0_flat: torch.Tensor,       # (B, nx)
    u_init: torch.Tensor,        # (B, T, na)
    running_cost,
    final_cost,
    config: ILQRConfig = ILQRConfig(),
    outer_iters: int = 2,
    classes=None,
    class_refresh: str = "rollout",
    refresh_fixed_point: int = 2,
):
    """Batched contact-model MPC replans on the frozen-mode fast path:
    ``solve_contact_mpc`` over B worlds with ``ilqr_solve_batch`` doing the
    inner iLQR. Returns (ILQRSolution, FrozenClasses): the classes of the
    winning trajectory ``sol.x`` under ``sol.u``, classified pointwise, to
    warm-start the next replan.

    The mode sequence of each world is derived from its plan, when
    ``classes`` is None (a warm start passes the previous replan's classes,
    which the first inner solve then takes as they are):

      * ``class_refresh="rollout"``: one full-LCP rollout per world (K6 when
        ``fused_class_rollout_ok``);
      * ``"pointwise"``: the fixed-point refresh, ``refresh_fixed_point``
        times from no clamping row: roll the plan out on the frozen-class
        step (K2 with one alpha and zero gains), then classify every
        (world, step) point by its own full LCP (``classify_points``, K7
        for a model with contact slots).

    On CUDA tensors with ``config.kernels`` a model that fails
    ``fused_class_rollout_ok`` raises under "rollout" rather than taking
    the plain scan."""
    if class_refresh not in ("rollout", "pointwise"):
        raise ValueError(f"unknown class_refresh {class_refresh!r}")
    B, T, na = u_init.shape
    m = lcp_dim(model)
    x0_flat = x0_flat.contiguous()

    def rollout_refresh(u):
        if frozen_contact.fused_class_rollout_ok(model):
            roll = rollout_classes if config.kernels else rollout_classes_plain
            return roll(model, x0_flat, u)[1]
        if config.kernels and x0_flat.is_cuda:
            raise NotImplementedError(
                "the class-rollout kernel needs fused_class_rollout_ok(model) "
                "(ROADMAP queue A, M4/M5: contact slots, loops, servos); "
                "class_refresh='pointwise' takes such models")
        return frozen_contact.rollout_classes(model, State.from_flat(x0_flat), u)[2]

    def pointwise_refresh(u):
        roll = rollout_gains if config.kernels else rollout_gains_plain
        nx = x0_flat.shape[-1]
        u = u.contiguous()
        z = u.new_zeros((B, T, m))
        cl = FrozenClasses(cmask=z, us=z)
        for _ in range(refresh_fixed_point):
            xss, _, _ = roll(model, running_cost, final_cost, x0_flat,
                             u.new_zeros(B, T + 1, nx), u, u.new_zeros(B, T, na, nx),
                             u.new_zeros(B, T, na), u.new_ones(1),
                             classes=(cl.cmask, cl.us), cg_iters=config.planner_cg_iters)
            cl, _ = frozen_contact.classify_points(model, xss[0][:, :-1],
                                                   model.action_to_tau(u),
                                                   kernels=config.kernels)
        return cl

    def classes_of(u):
        if m == 0:
            z = u.new_zeros((B, T, 0))
            return FrozenClasses(cmask=z, us=z)
        return pointwise_refresh(u) if class_refresh == "pointwise" else rollout_refresh(u)

    u, sol = u_init, None
    for _ in range(outer_iters):
        if classes is None or sol is not None:
            classes = classes_of(u)
        sol = ilqr_solve_batch(model, x0_flat, u, running_cost, final_cost, config,
                               classes=classes)
        u = sol.u
    if m > 0:
        cl_out, _ = frozen_contact.classify_points(model, sol.x[:, :-1],
                                                   model.action_to_tau(sol.u),
                                                   kernels=config.kernels)
        return sol, cl_out
    return sol, classes_of(u)
