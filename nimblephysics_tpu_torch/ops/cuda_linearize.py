"""K3 and K4: (fx, fu) of the planning step at every point of a batch of
trajectories.

Port of ``nimblephysics_tpu/ops/pallas_linearize.py``: ``linearize_pallas``
(K3, the contact-free step) and ``linearize_pallas_split`` (K4, the
frozen-class contact step) with their helpers ``dyn_for_trace`` and
``dyn_frozen_for_trace`` (the JAX helper ``_tau_stack`` is
``Model.action_to_tau`` here, which already stacks). ``linearize`` and
``linearize_split`` launch the CUDA kernels of ``csrc/linearize.cu`` on
CUDA tensors and run ``linearize_plain`` / ``linearize_split_plain``,
``torch.func.jacfwd`` of the plain step vmapped over the points, on CPU
tensors. The frozen step's solve carries the implicit tangent of a linear
solve (ops/frozen_contact.py), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops.contact import lcp_dim
from nimblephysics_tpu_torch.ops.frozen_contact import (
    FrozenClasses,
    frozen_contact_step,
    gov_matrix,
)
from nimblephysics_tpu_torch.simulation.step import forward_step


def dyn_for_trace(model: Model) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The planning dynamics x' = f(x, u): the contact-free step with the
    action mapped onto the actuated dofs."""

    def dyn(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return forward_step(model, State.from_flat(x), model.action_to_tau(u)).flat()

    return dyn


def dyn_frozen_for_trace(model: Model, cg_iters: Optional[int] = None):
    """The frozen-class contact planning dynamics x' = f(x, u, cmask, us)
    (ops/frozen_contact.py); ``cg_iters`` is the frozen solve's PCG depth
    (None: m + 6)."""
    gov = torch.as_tensor(gov_matrix(model), dtype=model.dtype, device=model.device)

    def dyn(x, u, cm, us):
        return frozen_contact_step(model, State.from_flat(x), model.action_to_tau(u),
                                   FrozenClasses(cmask=cm, us=us), gov,
                                   cg_iters=cg_iters).flat()

    return dyn


def _no_classes(classes) -> None:
    if classes is not None:
        raise NotImplementedError(
            "linearize with classes is K4, linearize_split (the JVP kernel's "
            "classes= is ROADMAP queue B, K3)")


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


def linearize_split_plain(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                          cg_iters: Optional[int] = None):
    """fx (B, T, nx, nx), fu (B, T, nx, na) of the frozen-class step, by
    jacfwd of the plain step; classes = (cmask, us), each (B, T, m)."""
    B, T, nx = xs.shape
    na = u.shape[-1]
    cm, us = classes
    m = cm.shape[-1]
    jac = torch.func.vmap(torch.func.jacfwd(dyn_frozen_for_trace(model, cg_iters),
                                            argnums=(0, 1)))
    fx, fu = jac(xs.reshape(B * T, nx), u.reshape(B * T, na), cm.reshape(B * T, m),
                 us.reshape(B * T, m))
    return fx.reshape(B, T, nx, nx), fu.reshape(B, T, nx, na)


def linearize_split(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                    cg_iters: Optional[int] = None):
    """(fx, fu) of the frozen-class step at every point (xs (B, T, nx)
    pre-step states, u (B, T, na), classes = (cmask, us) each (B, T, m)).
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    name = "linearize_split"
    cm, us = classes
    dev, dtype = _build.check_inputs(name, dict(xs=xs, u=u, cmask=cm, us=us),
                                     contiguous=("xs", "u", "cmask"))
    if xs.dim() != 3 or u.dim() != 3:
        raise ValueError(f"{name}: xs and u must be (B, T, nx) and (B, T, na)")
    B, T, nx = xs.shape
    na = u.shape[-1]
    m = lcp_dim(model)
    _build.check_shape(name, "xs", xs, (B, T, 2 * model.nq))
    _build.check_shape(name, "u", u, (B, T, model.num_actions))
    _build.check_shape(name, "cmask", cm, (B, T, m))
    _build.check_shape(name, "us", us, (B, T, m))
    if model.device != dev or model.dtype != dtype:
        raise ValueError(f"{name}: model is {model.dtype} on {model.device}, "
                         f"inputs are {dtype} on {dev}")
    if dev.type == "cpu":
        return linearize_split_plain(model, xs, u, classes, cg_iters)
    device_step.check_contact_model(name, model)
    n_cg = m + 6 if cg_iters is None else int(cg_iters)
    P, I = device_step.pack_model(model)
    fx = torch.empty((B, T, nx, nx), dtype=dtype, device=dev)
    fu = torch.empty((B, T, nx, na), dtype=dtype, device=dev)
    lib = _build.load()
    # us enters the frozen solve only through gov, which is zero for the
    # device's uncoupled rows: the kernel does not read it
    rc = lib.nptt_linearize_split(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, m, B * T, n_cg,
        P.data_ptr(), I.data_ptr(), xs.data_ptr(), u.data_ptr(), cm.data_ptr(),
        fx.data_ptr(), fu.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    linearize_split.launches += 1
    return fx, fu


linearize_split.launches = 0
