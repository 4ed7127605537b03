"""K8 and K9: the chained row-VJP linearize and the chained step rollout.

Port of ``nimblephysics_tpu/ops/lane_chain.py :: chained_linearize_vjp``
(K8) and ``chained_step_rollout`` (K9). The JAX module cuts the frozen-class
step's traced program into chains of Pallas kernels under an emitted-op
budget, because one kernel of the whole step exceeds what the TPU compiler
takes on large models; each chain computes the same function as the
one-kernel form. Hopper has no such limit (K5 builds and runs at m = 28),
so each function here launches the one-kernel form:

  * ``chained_linearize_vjp`` is K5 (``csrc/linearize.cu``, row-VJPs of the
    v' half; "same math as linearize_pallas_vjp", the JAX docstring);
  * ``chained_step_rollout`` is K2 (``csrc/rollout.cu``) on frozen classes
    at one alpha with zero gains: the open-loop rollout with each control
    clipped to the torque limits before its step, as the JAX chain's step
    function clips it. The running cost, on the unclipped controls and the
    pre-step states with no final cost, is evaluated in torch outside the
    kernel, as the JAX function evaluates it in XLA outside its kernels.

Each launches on CUDA tensors and counts its own launches; on CPU tensors
each runs its plain version (``chained_linearize_vjp_plain``,
``chained_step_rollout_plain``), which nothing on the CUDA path calls.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nimblephysics_tpu_torch.models.model import Model
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops.contact import lcp_dim
from nimblephysics_tpu_torch.ops.cuda_linearize import (
    _frozen_vjp,
    dyn_frozen_for_trace,
    linearize_vjp_plain,
)
from nimblephysics_tpu_torch.ops.cuda_rollout import _control_limits, launch_rollout


def chained_linearize_vjp_plain(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                                cg_iters: Optional[int] = None):
    """(fx, fu) by row-VJPs of the plain frozen step: ``linearize_vjp_plain``."""
    return linearize_vjp_plain(model, xs, u, classes, cg_iters)


def chained_linearize_vjp(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                          block_b: int = 128, interpret: Optional[bool] = None,
                          cg_iters: Optional[int] = None, budget: int = 36_000, wrap=None):
    """(fx, fu) of the frozen-class step at every point (xs (B, T, nx)
    pre-step states, u (B, T, na), classes = (cmask, us) each (B, T, m)),
    the q' rows analytic and the v' rows by row-VJPs, as the JAX function.

    ``block_b``, ``interpret``, ``budget`` and ``wrap`` are the JAX
    function's lane block, Pallas interpret switch, chain-cutting budget and
    per-launch wrapper; they are accepted and ignored, because Hopper needs
    no chain: on CUDA tensors this launches K5 whole. The plain version on
    CPU tensors."""
    return _frozen_vjp("chained_linearize_vjp", chained_linearize_vjp, model, xs, u,
                       classes, cg_iters)


chained_linearize_vjp.launches = 0


def _running_cost(running_cost: Callable, xs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sum over t of running_cost(xs[:, t], u[:, t], t), per world (B,)."""
    B, T, na = u.shape
    nx = xs.shape[-1]
    ts = torch.arange(T, device=u.device).repeat(B)
    c = torch.func.vmap(running_cost)(xs.reshape(B * T, nx), u.reshape(B * T, na), ts)
    return c.reshape(B, T).sum(dim=1)


def chained_step_rollout_plain(model: Model, running_cost: Callable, x0: torch.Tensor,
                               u: torch.Tensor, classes, cg_iters: Optional[int] = None):
    """The open-loop frozen-class rollout, step by step: x_{t+1} =
    frozen_contact_step(x_t, clip(u_t), classes_t). Returns (xs (B, T+1,
    nx), the running cost summed over t (B,))."""
    step = dyn_frozen_for_trace(model, cg_iters)
    lo, hi = _control_limits(model)
    cm, us = classes
    xs = [x0]
    for t in range(u.shape[1]):
        xs.append(step(xs[-1], torch.clamp(u[:, t], lo, hi), cm[:, t], us[:, t]))
    xs = torch.stack(xs, dim=1)
    return xs, _running_cost(running_cost, xs[:, :-1], u)


def chained_step_rollout(model: Model, running_cost: Callable, x0: torch.Tensor,
                         u: torch.Tensor, classes, block_b: int = 128,
                         interpret: Optional[bool] = None, cg_iters: Optional[int] = None,
                         budget: int = 36_000):
    """The open-loop frozen-class rollout (x0 (B, nx), u (B, T, na), classes
    = (cmask, us) each (B, T, m)): each step on the control clipped to the
    torque limits; returns (xs (B, T+1, nx), cost (B,)), the cost the sum
    over t of ``running_cost(x_t, u_t, t)`` on the given (unclipped)
    controls, with no final cost. ``running_cost`` may be any callable.

    ``block_b``, ``interpret`` and ``budget`` are accepted and ignored, as
    in ``chained_linearize_vjp``: on CUDA tensors the states come from K2
    at one alpha with zero gains. The plain version on CPU tensors."""
    name = "chained_step_rollout"
    cm, us = classes
    dev, dtype = _build.check_inputs(name, dict(x0=x0, u=u, cmask=cm, us=us),
                                     contiguous=("x0", "u", "cmask", "us"))
    if u.dim() != 3:
        raise ValueError(f"{name}: u must be (B, T, na)")
    B, T, na = u.shape
    nx = 2 * model.nq
    m = lcp_dim(model)
    _build.check_shape(name, "x0", x0, (B, nx))
    _build.check_shape(name, "u", u, (B, T, model.num_actions))
    _build.check_shape(name, "cmask", cm, (B, T, m))
    _build.check_shape(name, "us", us, (B, T, m))
    if model.device != dev or model.dtype != dtype:
        raise ValueError(f"{name}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {dev}")
    if dev.type == "cpu":
        return chained_step_rollout_plain(model, running_cost, x0, u, classes, cg_iters)
    device_step.check_frozen_model(name, model)
    n_cg = m + 6 if cg_iters is None else int(cg_iters)
    # K2's own cost is left at zero weights: the cost is taken below
    w = torch.zeros(2 * model.nq + na + 3 * nx, dtype=dtype, device=dev)
    xs, _, _ = launch_rollout(name, model, w, x0, u.new_zeros(B, T + 1, nx), u,
                              u.new_zeros(B, T, na, nx), u.new_zeros(B, T, na),
                              u.new_ones(1), (cm, us), n_cg)
    chained_step_rollout.launches += 1
    xs = xs[0]
    return xs, _running_cost(running_cost, xs[:, :-1], u)


chained_step_rollout.launches = 0
