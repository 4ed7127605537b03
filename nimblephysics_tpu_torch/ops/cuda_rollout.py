"""K2: closed-loop line-search rollouts for every (alpha, world) pair.

Port of ``nimblephysics_tpu/ops/pallas_rollout.py :: rollout_gains_pallas``.
``rollout_gains`` launches the CUDA kernel of ``csrc/rollout.cu`` on CUDA
tensors and runs ``rollout_gains_plain``, a loop over t with the same
arithmetic, on CPU tensors. On the card the cost must be data: a
``QuadraticCost`` and a ``QuadraticFinalCost`` (trajectory/costs.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops.cuda_linearize import _no_classes, dyn_for_trace
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost


def _control_limits(model: Model):
    act = list(model.actuated)
    return model.tau_lower[act], model.tau_upper[act]


def rollout_gains_plain(model: Model, running_cost: Callable, final_cost: Callable,
                        x0, xs_ref, u_ref, K, k, alphas):
    """xs (A, B, T+1, nx), us (A, B, T, na), costs (A, B): for each alpha,
    u_t = clip(u_ref + alpha k + K (x - x_ref)), stepped T times, with the
    running cost summed over t and the final cost added."""
    A = alphas.shape[0]
    B, T, na = u_ref.shape
    nx = x0.shape[-1]
    dyn = dyn_for_trace(model)
    lo, hi = _control_limits(model)
    run = torch.func.vmap(running_cost)
    fin = torch.func.vmap(final_cost)
    al = alphas[:, None, None]
    x = x0.expand(A, B, nx)
    xs, us = [x], []
    cost = x0.new_zeros(A, B)
    for t in range(T):
        dx = x - xs_ref[:, t]
        du = al * k[:, t] + (K[:, t] @ dx[..., None])[..., 0]
        u_t = torch.clamp(u_ref[:, t] + du, lo, hi)
        ts = torch.full((A * B,), t, device=x.device)
        cost = cost + run(x.reshape(A * B, nx), u_t.reshape(A * B, na), ts).reshape(A, B)
        x = dyn(x, u_t)
        xs.append(x)
        us.append(u_t)
    cost = cost + fin(x.reshape(A * B, nx)).reshape(A, B)
    return torch.stack(xs, dim=2), torch.stack(us, dim=2), cost


def rollout_gains(model: Model, running_cost: Callable, final_cost: Callable,
                  x0, xs_ref, u_ref, K, k, alphas, classes=None):
    """Closed-loop rollouts for every (alpha, world) pair; returns
    (xs, us, costs) as ``rollout_gains_plain``. The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    name = "rollout_gains"
    _no_classes(classes)
    dev, dtype = _build.check_inputs(
        name, dict(x0=x0, xs_ref=xs_ref, u_ref=u_ref, K=K, k=k, alphas=alphas),
        contiguous=("x0", "xs_ref", "u_ref", "K", "k", "alphas"))
    if u_ref.dim() != 3 or alphas.dim() != 1:
        raise ValueError(f"{name}: u_ref must be (B, T, na) and alphas (A,)")
    B, T, na = u_ref.shape
    nx = 2 * model.nq
    A = alphas.shape[0]
    for key, t, shape in (("x0", x0, (B, nx)), ("xs_ref", xs_ref, (B, T + 1, nx)),
                          ("u_ref", u_ref, (B, T, model.num_actions)),
                          ("K", K, (B, T, na, nx)), ("k", k, (B, T, na))):
        _build.check_shape(name, key, t, shape)
    if model.device != dev or model.dtype != dtype:
        raise ValueError(f"{name}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {dev}")
    if dev.type == "cpu":
        return rollout_gains_plain(model, running_cost, final_cost, x0, xs_ref,
                                   u_ref, K, k, alphas)
    if not (isinstance(running_cost, QuadraticCost)
            and isinstance(final_cost, QuadraticFinalCost)):
        raise TypeError(
            f"{name}: on the card the cost must be a QuadraticCost and a "
            "QuadraticFinalCost (ROADMAP queue B, K2: other costs on the card)")
    w = torch.cat([running_cost.wq, running_cost.wv, running_cost.wu,
                   final_cost.wx]).to(device=dev, dtype=dtype).contiguous()
    if w.shape[0] != 2 * model.nq + na + nx:
        raise ValueError(f"{name}: cost weights do not match the model")
    P, I = device_step.pack_model(model)
    xs = torch.empty((A, B, T + 1, nx), dtype=dtype, device=dev)
    us = torch.empty((A, B, T, na), dtype=dtype, device=dev)
    costs = torch.empty((A, B), dtype=dtype, device=dev)
    lib = _build.load()
    rc = lib.nptt_rollout(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, A, B, T,
        P.data_ptr(), I.data_ptr(), w.data_ptr(), x0.data_ptr(), xs_ref.data_ptr(),
        u_ref.data_ptr(), K.data_ptr(), k.data_ptr(), alphas.data_ptr(),
        xs.data_ptr(), us.data_ptr(), costs.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    rollout_gains.launches += 1
    return xs, us, costs


rollout_gains.launches = 0
