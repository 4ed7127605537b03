"""First-order optimizers over dicts of tensors, with optax's semantics.

The JAX package's SSID and shooting solvers run ``optax.adam`` and
``optax.sgd``; these are the same updates written out, so that the port's
iterates follow the JAX package's operation for operation:

    adam:  mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
           update = -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    sgd:   update = -lr g

with optax's defaults b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0 (the
update ``torch.optim.Adam``'s defaults compute too, rounded otherwise).
Parameters and gradients are dicts of tensors; nothing is updated in
place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()})


def adam_update(grads: Params, state: AdamState, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> Tuple[Params, AdamState]:
    count = state.count + 1
    mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
    nu = {k: (1 - b2) * g**2 + b2 * state.nu[k] for k, g in grads.items()}
    c1, c2 = 1 - b1**count, 1 - b2**count
    updates = {k: -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in grads}
    return updates, AdamState(count, mu, nu)


def make_optimizer(name: str, lr: float) -> Tuple[Callable, Callable]:
    """(init, update) of ``optax.adam(lr)`` or ``optax.sgd(lr)``; update
    maps (grads, state) to (updates, state)."""
    if name == "adam":
        return adam_init, lambda g, s: adam_update(g, s, lr)
    if name == "sgd":
        return (lambda params: None,
                lambda g, s: ({k: -lr * x for k, x in g.items()}, s))
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all leaves together, summed in the
    order of the keys (a JAX dict's leaf order)."""
    return torch.sqrt(sum(torch.sum(tree[k] ** 2) for k in sorted(tree)))


def value_and_grad(fn: Callable, params: Params):
    """(fn(params), d fn / d params) by reverse mode; a parameter the value
    does not depend on gets a zero gradient, as under jax.grad. Extra
    outputs of fn (a tuple) come back detached beside the value."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    out = fn(leaves)
    val, aux = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
    keys = list(leaves)
    grads = torch.autograd.grad(val, [leaves[k] for k in keys], allow_unused=True)
    g = {k: torch.zeros_like(leaves[k]) if gk is None else gk for k, gk in zip(keys, grads)}
    val = val.detach()
    if aux:
        return (val,) + tuple(a.detach() for a in aux), g
    return val, g
