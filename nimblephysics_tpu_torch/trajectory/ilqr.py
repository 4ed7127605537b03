"""iLQR for the MPC layer: the contact-free batched replan.

PyTorch counterpart of ``nimblephysics_tpu/trajectory/ilqr.py``:

  * ``ilqr_solve``: one world, the sequential Riccati recursion with Tassa
    regularisation, the alpha ladder and the reg schedule — the plain
    end-to-end reference, with no kernel.
  * ``ilqr_solve_batch``: B worlds at once, the same iteration as
    ``vmap(ilqr_solve)``, with the three kernels where the JAX package runs
    its three Pallas kernels: linearize (K3), the Riccati backward (K1) and
    the line-search rollout (K2), the last also for the first open-loop
    rollout.

The cost derivatives (lx, lu, lxx, luu, lux, Vx_T, Vxx_T) come from
``torch.func`` outside any kernel. Models with constraint rows are refused
up front, so the dynamics is the contact-free ``dyn_for_trace`` (the JAX
package's ``_make_dyn``). Forward-only, like the JAX solver's
batched path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, vmap

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops.contact import lcp_dim
from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_for_trace, linearize, linearize_plain
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward, riccati_backward_plain
from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_gains, rollout_gains_plain
from nimblephysics_tpu_torch.ops.linalg_small import inv_spd_pivots


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
    # ilqr_solve_batch: False runs the plain PyTorch versions of the three
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


def _check(model: Model, config: ILQRConfig, classes, dtype, device) -> None:
    if classes is not None:
        raise NotImplementedError(
            "classes (frozen-contact iLQR) are not ported yet (ROADMAP queue A, M5)")
    if config.riccati != "sequential":
        raise NotImplementedError(
            f"riccati={config.riccati!r} is not ported yet (ROADMAP queue A, M3)")
    if config.iters < 1:
        raise ValueError("iters must be at least 1")
    if model.device != device or model.dtype != dtype:
        raise ValueError(f"model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {device}")
    if lcp_dim(model) > 0:
        raise NotImplementedError(
            "models with constraint rows (joint limits, Coulomb friction) need "
            "the frozen-contact path (ROADMAP queue A, M4/M5); plan on "
            "relax_limits(model)")


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
    card they must be a QuadraticCost and a QuadraticFinalCost."""
    B, T, na = u_init.shape
    dtype, device = u_init.dtype, u_init.device
    _check(model, config, classes, dtype, device)
    nx = x0_flat.shape[-1]
    if config.kernels:
        lin, ric, roll = linearize, riccati_backward, rollout_gains
    else:
        lin, ric, roll = linearize_plain, riccati_backward_plain, rollout_gains_plain
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
    Tassa regularisation Vxx + reg I inside the fu products)."""
    T, na = u_init.shape
    dtype, device = u_init.dtype, u_init.device
    _check(model, config, classes, dtype, device)
    dyn = dyn_for_trace(model)
    clamp = _controls_clamp(model)
    xflat0 = x0.flat()
    nx = xflat0.shape[-1]
    ts = torch.arange(T, device=device)
    eye = torch.eye(nx, dtype=dtype, device=device)

    def rollout_controls(u):
        xs = [xflat0]
        for t in range(T):
            xs.append(dyn(xs[-1], u[t]))
        return torch.stack(xs)

    def traj_cost(xs, u):
        return vmap(running_cost)(xs[:-1], u, ts).sum() + final_cost(xs[-1])

    def rollout_with_gains(xs_ref, u_ref, K, k, alpha):
        x, xs, us = xflat0, [xflat0], []
        for t in range(T):
            u_t = clamp(u_ref[t] + alpha * k[t] + K[t] @ (x - xs_ref[t]))
            x = dyn(x, u_t)
            xs.append(x)
            us.append(u_t)
        return torch.stack(xs), torch.stack(us)

    dyn_jac = vmap(jacfwd(dyn, argnums=(0, 1)))

    def backward(xs, u, reg):
        fx, fu = dyn_jac(xs[:-1], u)
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
