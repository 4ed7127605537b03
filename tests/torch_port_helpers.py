"""Shared helpers of the tests/test_torch_*.py files: carry a JAX package
model into the PyTorch port through numpy, and the bench.py cartpole task
on both sides."""

import numpy as np
import jax.numpy as jnp
import torch

from nimblephysics_tpu_torch.models.convert import model_from_numpy
from nimblephysics_tpu_torch.models.model import LEAF_NAMES
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost


def jax_leaves(model) -> dict:
    """A JAX Model's numeric leaves as numpy arrays, by port leaf name."""
    out = {}
    for name in LEAF_NAMES:
        field, _, part = name.partition(".")
        val = getattr(model, field)
        out[name] = np.asarray(getattr(val, part) if part else val)
    return out


def jax_static(model) -> dict:
    """The static topology, the collision shapes among it (JAX ShapeSpecs,
    which model_from_numpy reads through numpy)."""
    assert not model.custom_specs and not model.loops
    return dict(joint_types=model.joint_types, parents=model.parents,
                joint_names=model.joint_names, body_names=model.body_names,
                actuated=model.actuated, dof_names=model.dof_names, shapes=model.shapes)


def to_port(model, dtype=None):
    """The port's Model on the CPU with the JAX model's leaves (their own
    float64 unless ``dtype`` is given)."""
    return model_from_numpy(jax_static(model), jax_leaves(model), device="cpu",
                            dtype=dtype)


def jax_cartpole_costs(nq):
    """bench.py's cartpole costs, JAX side."""

    def running(x, u, t):
        return 0.1 * jnp.sum(x[:nq] ** 2) + 1e-3 * jnp.sum(u ** 2)

    def final(x):
        return 10.0 * jnp.sum(x ** 2)

    return running, final


def port_cartpole_costs(model):
    """The same costs as QuadraticCost / QuadraticFinalCost."""
    return QuadraticCost(model, wq=0.1, wu=1e-3), QuadraticFinalCost(model, wx=10.0)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def iterate_through_pcg(monkeypatch):
    """Make the port's solve_frozen take forward mode through its PCG
    iterations (the derivative of the truncated iteration) instead of the
    implicit tangent that the JAX package's lax.custom_linear_solve gives:
    the wrong tangent, to show that a comparison rejects it."""
    from nimblephysics_tpu_torch.ops import frozen_contact

    class _Iterated:
        @staticmethod
        def apply(Qf, reg, diagM, bvec, n_cg):
            return frozen_contact._pcg(Qf, reg, diagM, bvec, n_cg)

    monkeypatch.setattr(frozen_contact, "_FrozenPCG", _Iterated)
