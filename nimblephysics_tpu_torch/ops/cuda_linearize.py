"""K3, K4 and K5: (fx, fu) of the planning step at every point of a batch
of trajectories.

Port of ``nimblephysics_tpu/ops/pallas_linearize.py``: ``linearize_pallas``
(K3, the contact-free step), ``linearize_pallas_split`` (K4, the
frozen-class contact step by forward mode) and ``linearize_pallas_vjp``
(K5, the frozen-class step by row-VJPs of its v' half, with
``linear_position_update``), with their helpers ``dyn_for_trace`` and
``dyn_frozen_for_trace`` (the JAX helper ``_tau_stack`` is
``Model.action_to_tau`` here, which already stacks). ``linearize``,
``linearize_split`` and ``linearize_vjp`` launch the CUDA kernels of
``csrc/linearize_free.cu`` (K3) and ``csrc/linearize.cu`` (K4, K5) on CUDA
tensors (``linearize`` with ``classes=``, the
JAX kernel's monolithic JVP on frozen classes, launches K4's kernel, which
on Hopper already is one; at the jump worm's m = 28 K4 and K5 run on lane
groups, csrc/frozen_group.cuh) and run their plain versions,
``torch.func.jacfwd`` (K3, K4) or ``torch.func.jacrev`` (K5) of the plain
step vmapped over the points, on CPU tensors. The frozen step's solve
carries the derivatives of a linear solve (ops/frozen_contact.py), as in
the JAX package: forward mode and reverse mode agree only where its
truncated PCG has converged.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nimblephysics_tpu_torch.models.model import Model, State
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops.collide import total_slots
from nimblephysics_tpu_torch.ops.contact import lcp_dim
from nimblephysics_tpu_torch.ops.frozen_contact import (
    FrozenClasses,
    frozen_contact_step,
    gov_matrix,
)
from nimblephysics_tpu_torch.simulation.step import forward_step


# points per call of a plain version's vmapped Jacobian: all B T points at
# once would hold their (points, directions, m, m) intermediates together
_PLAIN_CHUNK = 16384


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


def linearize_plain(model: Model, xs: torch.Tensor, u: torch.Tensor):
    """fx (B, T, nx, nx), fu (B, T, nx, na) by jacfwd of the plain step."""
    B, T, nx = xs.shape
    na = u.shape[-1]
    jac = torch.func.vmap(torch.func.jacfwd(dyn_for_trace(model), argnums=(0, 1)))
    fx, fu = jac(xs.reshape(B * T, nx), u.reshape(B * T, na))
    return fx.reshape(B, T, nx, nx), fu.reshape(B, T, nx, na)


def linearize(model: Model, xs: torch.Tensor, u: torch.Tensor, classes=None):
    """(fx, fu) at every point (xs (B, T, nx) pre-step states, u (B, T, na)).
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors.

    With ``classes`` = (cmask, us), each (B, T, m): (fx, fu) of the
    frozen-class step by forward mode, as ``linearize_pallas(classes=)``,
    whose frozen solve always runs the default PCG depth m + 6 (it takes no
    ``cg_iters``). On CUDA that is K4's kernel at depth m + 6, counted in
    ``linearize.launches``; the plain version is ``linearize_split_plain``
    at m + 6."""
    name = "linearize"
    if classes is not None:
        return _frozen_jvp(name, linearize, model, xs, u, classes, None)
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
    flat = (xs.reshape(B * T, nx), u.reshape(B * T, na), cm.reshape(B * T, m),
            us.reshape(B * T, m))
    # in chunks of points, as linearize_vjp_plain
    cols = [jac(*(a[i:i + _PLAIN_CHUNK] for a in flat)) for i in range(0, B * T, _PLAIN_CHUNK)]
    fx = torch.cat([c[0] for c in cols])
    fu = torch.cat([c[1] for c in cols])
    return fx.reshape(B, T, nx, nx), fu.reshape(B, T, nx, na)


def linearize_split(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                    cg_iters: Optional[int] = None):
    """(fx, fu) of the frozen-class step at every point (xs (B, T, nx)
    pre-step states, u (B, T, na), classes = (cmask, us) each (B, T, m)).
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    return _frozen_jvp("linearize_split", linearize_split, model, xs, u, classes, cg_iters)


def _frozen_jvp(name: str, wrapper, model: Model, xs, u, classes, cg_iters):
    """K4 for ``linearize_split`` and ``linearize(classes=)``: validate, run
    the plain version on CPU tensors, else launch the kernel and count the
    launch on ``wrapper``."""
    cm, us = classes
    dev, dtype = _build.check_inputs(name, dict(xs=xs, u=u, cmask=cm, us=us),
                                     contiguous=("xs", "u", "cmask", "us"))
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
    device_step.check_frozen_model(name, model)
    n_cg = m + 6 if cg_iters is None else int(cg_iters)
    P, I = device_step.pack_model(model)
    fx = torch.empty((B, T, nx, nx), dtype=dtype, device=dev)
    fu = torch.empty((B, T, nx, na), dtype=dtype, device=dev)
    lib = _build.load()
    rc = lib.nptt_linearize_split(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, m, B * T, n_cg,
        P.data_ptr(), I.data_ptr(), xs.data_ptr(), u.data_ptr(), cm.data_ptr(),
        us.data_ptr(), fx.data_ptr(), fu.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    wrapper.launches += 1
    return fx, fu


linearize_split.launches = 0


def linear_position_update(model: Model) -> bool:
    """True when every joint integrates its positions linearly (q' = q +
    dt v): every joint type but the exp-map ball and free retractions. K5
    takes the q' rows of the Jacobian analytically under it."""
    return all(t not in ("ball", "free") for t in model.joint_types)


def _analytic_top(model: Model, B: int, T: int, dtype, device):
    """The q' rows of (fx, fu) under a linear position update: [I, dt I]
    and 0."""
    nq, na = model.nq, model.num_actions
    eye = torch.eye(nq, dtype=dtype, device=device)
    top = torch.cat([eye, model.dt.to(dtype) * eye], dim=-1)
    return (top.expand(B, T, nq, 2 * nq),
            torch.zeros((B, T, nq, na), dtype=dtype, device=device))


def linearize_vjp_plain(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                        cg_iters: Optional[int] = None):
    """fx (B, T, nx, nx), fu (B, T, nx, na) of the frozen-class step: the
    q' rows analytic, the v' rows by jacrev of the v' half of the plain
    frozen step (reverse mode through the frozen solve's transposed linear
    solve); classes = (cmask, us), each (B, T, m)."""
    B, T, nx = xs.shape
    na, nq = u.shape[-1], model.nq
    cm, us = classes
    m = cm.shape[-1]
    dyn = dyn_frozen_for_trace(model, cg_iters)
    jac = torch.func.vmap(torch.func.jacrev(
        lambda x, uu, c, s: dyn(x, uu, c, s)[nq:], argnums=(0, 1)))
    flat = (xs.reshape(B * T, nx), u.reshape(B * T, na), cm.reshape(B * T, m),
            us.reshape(B * T, m))
    rows = [jac(*(a[i:i + _PLAIN_CHUNK] for a in flat)) for i in range(0, B * T, _PLAIN_CHUNK)]
    fx_bot = torch.cat([r[0] for r in rows])
    fu_bot = torch.cat([r[1] for r in rows])
    fx_top, fu_top = _analytic_top(model, B, T, xs.dtype, xs.device)
    return (torch.cat([fx_top, fx_bot.reshape(B, T, nq, nx)], dim=2),
            torch.cat([fu_top, fu_bot.reshape(B, T, nq, na)], dim=2))


def linearize_vjp(model: Model, xs: torch.Tensor, u: torch.Tensor, classes,
                  cg_iters: Optional[int] = None):
    """(fx, fu) of the frozen-class step at every point by row-VJPs of its
    v' half (xs (B, T, nx) pre-step states, u (B, T, na), classes =
    (cmask, us) each (B, T, m)); the model must pass
    ``linear_position_update``. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return _frozen_vjp("linearize_vjp", linearize_vjp, model, xs, u, classes, cg_iters)


def _frozen_vjp(name: str, wrapper, model: Model, xs, u, classes, cg_iters):
    """K5 for ``linearize_vjp`` and the port's ``chained_linearize_vjp``:
    validate, run the plain version on CPU tensors, else launch the kernel
    and count the launch on ``wrapper``."""
    cm, us = classes
    dev, dtype = _build.check_inputs(name, dict(xs=xs, u=u, cmask=cm, us=us),
                                     contiguous=("xs", "u", "cmask", "us"))
    if xs.dim() != 3 or u.dim() != 3:
        raise ValueError(f"{name}: xs and u must be (B, T, nx) and (B, T, na)")
    if not linear_position_update(model):
        raise ValueError(f"{name}: the row-VJP linearize needs linear position updates")
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
        return linearize_vjp_plain(model, xs, u, classes, cg_iters)
    device_step.check_frozen_model(name, model)
    n_cg = m + 6 if cg_iters is None else int(cg_iters)
    P, I = device_step.pack_model(model)
    fx = torch.empty((B, T, nx, nx), dtype=dtype, device=dev)
    fu = torch.empty((B, T, nx, na), dtype=dtype, device=dev)
    lib = _build.load()
    rc = lib.nptt_linearize_vjp(
        int(dtype == torch.float64), model.num_bodies, model.nq, na, m,
        total_slots(model), B * T, n_cg, P.data_ptr(), I.data_ptr(),
        xs.data_ptr(), u.data_ptr(), cm.data_ptr(), us.data_ptr(), fx.data_ptr(),
        fu.data_ptr(), _build.stream_ptr(dev))
    _build.check(rc, name)
    wrapper.launches += 1
    return fx, fu


linearize_vjp.launches = 0
