"""K3: (fx, fu) of the planning step at every point of a batch of
trajectories.

Port of ``nimblephysics_tpu/ops/pallas_linearize.py :: linearize_pallas``
and its helper ``dyn_for_trace`` (the JAX helper ``_tau_stack`` is
``Model.action_to_tau`` here, which already stacks). ``linearize``
launches the CUDA kernel of ``csrc/linearize.cu`` on CUDA tensors and runs
``linearize_plain``, ``torch.func.jacfwd`` of the plain step vmapped over
the points, on CPU tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.simulation.step import forward_step


def dyn_for_trace(model: Model) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The planning dynamics x' = f(x, u): the contact-free step with the
    action mapped onto the actuated dofs."""

    def dyn(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return forward_step(model, State.from_flat(x), model.action_to_tau(u)).flat()

    return dyn


def _no_classes(classes) -> None:
    if classes is not None:
        raise NotImplementedError(
            "frozen-contact classes are not ported yet (ROADMAP queue A, M5)")


def linearize_plain(model: Model, xs: torch.Tensor, u: torch.Tensor):
    """fx (B, T, nx, nx), fu (B, T, nx, na) by jacfwd of the plain step."""
    B, T, nx = xs.shape
    na = u.shape[-1]
    jac = torch.func.vmap(torch.func.jacfwd(dyn_for_trace(model), argnums=(0, 1)))
    fx, fu = jac(xs.reshape(B * T, nx), u.reshape(B * T, na))
    return fx.reshape(B, T, nx, nx), fu.reshape(B, T, nx, na)


def linearize(model: Model, xs: torch.Tensor, u: torch.Tensor, classes=None):
    """(fx, fu) at every point (xs (B, T, nx) pre-step states, u (B, T, na)).
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    name = "linearize"
    _no_classes(classes)
    dev, dtype = _build.check_inputs(name, dict(xs=xs, u=u), contiguous=("xs", "u"))
    if xs.dim() != 3 or u.dim() != 3:
        raise ValueError(f"{name}: xs and u must be (B, T, nx) and (B, T, na)")
    B, T, nx = xs.shape
    na = u.shape[-1]
    _build.check_shape(name, "xs", xs, (B, T, 2 * model.nq))
    _build.check_shape(name, "u", u, (B, T, model.num_actions))
    if model.device != dev or model.dtype != dtype:
        raise ValueError(f"{name}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {dev}")
    if dev.type == "cpu":
        return linearize_plain(model, xs, u)
    P, I = device_step.pack_model(model)
    fx = torch.empty((B, T, nx, nx), dtype=dtype, device=dev)
    fu = torch.empty((B, T, nx, na), dtype=dtype, device=dev)
    lib = _build.load()
    rc = lib.nptt_linearize(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, B * T,
        P.data_ptr(), I.data_ptr(), xs.data_ptr(), u.data_ptr(),
        fx.data_ptr(), fu.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    linearize.launches += 1
    return fx, fu


linearize.launches = 0
