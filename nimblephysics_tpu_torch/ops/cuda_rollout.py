"""K2: closed-loop line-search rollouts for every (alpha, world) pair, on
the contact-free step or on frozen classes; K6: the full-LCP class rollout.

Port of ``nimblephysics_tpu/ops/pallas_rollout.py :: rollout_gains_pallas``
and ``rollout_classes_pallas``. ``rollout_gains`` and ``rollout_classes``
launch the CUDA kernels of ``csrc/rollout.cu`` on CUDA tensors and run
``rollout_gains_plain`` / ``rollout_classes_plain``, loops over t with the
same arithmetic, on CPU tensors. On the card the cost must be data: a
``QuadraticCost`` and a ``QuadraticFinalCost`` (trajectory/costs.py), their
targets included.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops.collide import total_slots
from nimblephysics_tpu_torch.ops.contact import lcp_dim
from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_for_trace, dyn_frozen_for_trace
from nimblephysics_tpu_torch.ops.frozen_contact import FrozenClasses, step_with_classes_for_trace
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost


def _control_limits(model: Model):
    act = list(model.actuated)
    return model.tau_lower[act], model.tau_upper[act]


def rollout_gains_plain(model: Model, running_cost: Callable, final_cost: Callable,
                        x0, xs_ref, u_ref, K, k, alphas, classes=None,
                        cg_iters: Optional[int] = None):
    """xs (A, B, T+1, nx), us (A, B, T, na), costs (A, B): for each alpha,
    u_t = clip(u_ref + alpha k + K (x - x_ref)), stepped T times, with the
    running cost summed over t and the final cost added. With classes =
    (cmask, us), each (B, T, m), the step is the frozen-class step."""
    A = alphas.shape[0]
    B, T, na = u_ref.shape
    nx = x0.shape[-1]
    if classes is None:
        step = dyn_for_trace(model)
        dyn = lambda x, u_t, t: step(x, u_t)  # noqa: E731
    else:
        step = dyn_frozen_for_trace(model, cg_iters)
        m = classes[0].shape[-1]

        def dyn(x, u_t, t):
            cm = classes[0][:, t].expand(A, B, m)
            us = classes[1][:, t].expand(A, B, m)
            return step(x, u_t, cm, us)
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
        x = dyn(x, u_t, t)
        xs.append(x)
        us.append(u_t)
    cost = cost + fin(x.reshape(A * B, nx)).reshape(A, B)
    return torch.stack(xs, dim=2), torch.stack(us, dim=2), cost


def rollout_gains(model: Model, running_cost: Callable, final_cost: Callable,
                  x0, xs_ref, u_ref, K, k, alphas, classes=None,
                  cg_iters: Optional[int] = None):
    """Closed-loop rollouts for every (alpha, world) pair; returns
    (xs, us, costs) as ``rollout_gains_plain``. The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    name = "rollout_gains"
    tensors = dict(x0=x0, xs_ref=xs_ref, u_ref=u_ref, K=K, k=k, alphas=alphas)
    if classes is not None:
        tensors.update(cmask=classes[0], us=classes[1])
    dev, dtype = _build.check_inputs(
        name, tensors, contiguous=("x0", "xs_ref", "u_ref", "K", "k", "alphas", "cmask", "us"))
    if u_ref.dim() != 3 or alphas.dim() != 1:
        raise ValueError(f"{name}: u_ref must be (B, T, na) and alphas (A,)")
    B, T, na = u_ref.shape
    nx = 2 * model.nq
    A = alphas.shape[0]
    for key, t, shape in (("x0", x0, (B, nx)), ("xs_ref", xs_ref, (B, T + 1, nx)),
                          ("u_ref", u_ref, (B, T, model.num_actions)),
                          ("K", K, (B, T, na, nx)), ("k", k, (B, T, na))):
        _build.check_shape(name, key, t, shape)
    m = 0
    if classes is not None:
        m = lcp_dim(model)
        _build.check_shape(name, "cmask", classes[0], (B, T, m))
        _build.check_shape(name, "us", classes[1], (B, T, m))
    if model.device != dev or model.dtype != dtype:
        raise ValueError(f"{name}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {dev}")
    if dev.type == "cpu":
        return rollout_gains_plain(model, running_cost, final_cost, x0, xs_ref,
                                   u_ref, K, k, alphas, classes, cg_iters)
    if classes is not None:
        device_step.check_frozen_model(name, model)
    n_cg = m + 6 if cg_iters is None else int(cg_iters)
    if not (isinstance(running_cost, QuadraticCost)
            and isinstance(final_cost, QuadraticFinalCost)):
        raise TypeError(
            f"{name}: on the card the cost must be a QuadraticCost and a "
            "QuadraticFinalCost (ROADMAP queue B, K2: other costs on the card)")
    w = torch.cat([running_cost.wq, running_cost.wv, running_cost.wu, final_cost.wx,
                   running_cost.x_goal, final_cost.x_goal]).to(device=dev, dtype=dtype).contiguous()
    if w.shape[0] != 2 * model.nq + na + 3 * nx:
        raise ValueError(f"{name}: cost weights do not match the model")
    out = launch_rollout(name, model, w, x0, xs_ref, u_ref, K, k, alphas, classes, n_cg)
    rollout_gains.launches += 1
    return out


def launch_rollout(name: str, model: Model, w, x0, xs_ref, u_ref, K, k, alphas, classes,
                   n_cg: int):
    """K2's launch on validated CUDA tensors, the cost weights packed in
    ``w`` (csrc/rollout.cu); returns (xs, us, costs). The caller counts the
    launch."""
    B, T, na = u_ref.shape
    nx = 2 * model.nq
    A = alphas.shape[0]
    dtype, dev = x0.dtype, x0.device
    m = 0 if classes is None else classes[0].shape[-1]
    P, I = device_step.pack_model(model)
    xs = torch.empty((A, B, T + 1, nx), dtype=dtype, device=dev)
    us = torch.empty((A, B, T, na), dtype=dtype, device=dev)
    costs = torch.empty((A, B), dtype=dtype, device=dev)
    lib = _build.load()
    # the class masks (B, T, m)
    cm_ptr, us_ptr = (0, 0) if classes is None else (classes[0].data_ptr(),
                                                     classes[1].data_ptr())
    ns = total_slots(model) if classes is not None else 0
    rc = lib.nptt_rollout(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, m, ns, A, B, T, n_cg,
        P.data_ptr(), I.data_ptr(), w.data_ptr(), x0.data_ptr(), xs_ref.data_ptr(),
        u_ref.data_ptr(), K.data_ptr(), k.data_ptr(), alphas.data_ptr(), cm_ptr, us_ptr,
        xs.data_ptr(), us.data_ptr(), costs.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    return xs, us, costs


rollout_gains.launches = 0


def rollout_classes_plain(model: Model, x0: torch.Tensor, u: torch.Tensor):
    """The full-LCP rollout recording the mode sequence: T steps of
    ``step_with_classes_for_trace``. Returns (xs (B, T, nx) post-step
    states, FrozenClasses with (B, T, m) masks)."""
    step = step_with_classes_for_trace(model)
    x, xs, cms, uss = x0, [], [], []
    for t in range(u.shape[1]):
        x, cm, us = step(x, u[:, t])
        xs.append(x)
        cms.append(cm)
        uss.append(us)
    return (torch.stack(xs, dim=1),
            FrozenClasses(cmask=torch.stack(cms, dim=1), us=torch.stack(uss, dim=1)))


def rollout_classes(model: Model, x0: torch.Tensor, u: torch.Tensor):
    """The per-replan full-LCP mode rollout (x0 (B, nx), u (B, T, na));
    returns (xs, FrozenClasses) as ``rollout_classes_plain``. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    name = "rollout_classes"
    dev, dtype = _build.check_inputs(name, dict(x0=x0, u=u), contiguous=("x0",))
    if u.dim() != 3:
        raise ValueError(f"{name}: u must be (B, T, na)")
    B, T, na = u.shape
    nx = 2 * model.nq
    _build.check_shape(name, "x0", x0, (B, nx))
    _build.check_shape(name, "u", u, (B, T, model.num_actions))
    if model.device != dev or model.dtype != dtype:
        raise ValueError(f"{name}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {dev}")
    if dev.type == "cpu":
        return rollout_classes_plain(model, x0, u)
    m = device_step.check_contact_model(name, model)
    P, I = device_step.pack_model(model)
    u_tb = u.permute(1, 2, 0).contiguous()                        # (T, na, B)
    out = torch.empty((T, nx + m, B), dtype=dtype, device=dev)
    lib = _build.load()
    rc = lib.nptt_rollout_classes(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, m, B, T,
        P.data_ptr(), I.data_ptr(), x0.data_ptr(), u_tb.data_ptr(), out.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(rc, name)
    rollout_classes.launches += 1
    rows = out.permute(2, 0, 1)                                   # (B, T, nx + m)
    cm = rows[..., nx:].contiguous()
    # no device row is friction-coupled, so none is UPPER: us = 0
    return rows[..., :nx].contiguous(), FrozenClasses(cmask=cm, us=torch.zeros_like(cm))


rollout_classes.launches = 0
