"""Contact slots for shape-free models.

PyTorch counterpart of ``ContactSlots``, ``total_slots`` and
``detect_contacts`` in ``nimblephysics_tpu/ops/collide.py``, for models
without collision shapes: they have no contact slots, so the constraint
rows come from joint limits and Coulomb friction alone. The narrow-phase
pair functions are ROADMAP M4; a model with shapes raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from nimblephysics_tpu_torch.models.model import Model


class ContactSlots(NamedTuple):
    """Fixed-size contact buffers (n_slots, ...)."""

    point: torch.Tensor        # (K, 3) world contact point
    normal: torch.Tensor       # (K, 3) world normal, B -> A
    depth: torch.Tensor        # (K,) penetration depth (>0 = contact)
    active: torch.Tensor       # (K,) bool
    body_a: Tuple[int, ...]    # static body indices (-1 = world/static)
    body_b: Tuple[int, ...]
    friction: torch.Tensor     # (K,) combined friction coefficient
    restitution: torch.Tensor  # (K,) combined restitution


def _no_shapes(model: Model) -> None:
    if model.shapes:
        raise NotImplementedError(
            "collision shapes are not ported yet (ROADMAP queue A, M4: the "
            "narrow-phase pair functions of ops/collide.py)")


def total_slots(model: Model) -> int:
    _no_shapes(model)
    return 0


def detect_contacts(model: Model, T_wb: List) -> ContactSlots:
    """Every contact slot from the body transforms: none for a shape-free
    model."""
    _no_shapes(model)
    z3 = model.mass.new_zeros((0, 3))
    z = model.mass.new_zeros((0,))
    return ContactSlots(z3, z3, z, torch.zeros((0,), dtype=torch.bool, device=z.device),
                        (), (), z, z)
