"""Programmatic builders for the contact-free benchmark worlds.

PyTorch counterpart of ``pendulum``, ``inverted_double_pendulum`` and
``cartpole`` in ``nimblephysics_tpu/models/builders.py``. The leaves are
computed in float64 exactly as the JAX package computes them and then cast
to ``dtype`` on ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nimblephysics_tpu_torch.models.model import Model, build_model
from nimblephysics_tpu_torch.ops import spatial
from nimblephysics_tpu_torch.ops.lie import Transform


def _tf(p=(0, 0, 0), R=None) -> Transform:
    return Transform(
        np.eye(3) if R is None else np.asarray(R, dtype=np.float64),
        np.asarray(p, dtype=np.float64),
    )


def _f64(*vals):
    return [torch.tensor(v, dtype=torch.float64) for v in vals]


def _box(mass, size):
    return spatial.box_inertia(*_f64(mass, size)).numpy()


def _capsule(mass, radius, height):
    return spatial.capsule_inertia(*_f64(mass, radius, height)).numpy()


def pendulum(
    n_links: int = 1, dt: float = 0.01, damping: float = 0.0,
    dtype: Optional[torch.dtype] = None, device="cuda",
) -> Model:
    """Chain of revolute joints about z, each link a unit point mass 1 m
    below its joint."""
    joints = []
    for i in range(n_links):
        joints.append(
            dict(
                type="revolute", name=f"j{i}", body_name=f"link{i}",
                parent=i - 1, axes=[[0.0, 0.0, 1.0]],
                T_pj=_tf() if i == 0 else _tf([0.0, -1.0, 0.0]),
                mass=1.0, com=[0.0, -1.0, 0.0], moment=np.eye(3) * 1e-8,
                damping=damping,
            )
        )
    return build_model(joints, dt=dt, dtype=dtype, device=device)


def inverted_double_pendulum(
    dt: float = 0.01, dtype: Optional[torch.dtype] = None, device="cuda",
) -> Model:
    """Cart (prismatic x) + two poles (revolute z, damping 0.1) + a welded
    tip weight; the cart force is the only action."""
    sk = np.array([0.0, -0.35, 0.0])
    cart_p = sk + np.array([0.0, 0.0, 0.0])
    pole_p = sk + np.array([0.0, 0.0, 0.0])
    pole2_p = sk + np.array([0.0, 0.3, 0.0])
    weight_p = sk + np.array([0.0, 0.62, 0.0])
    joints = [
        dict(
            type="prismatic", name="j_cart", body_name="cart", parent=-1,
            axes=[[1.0, 0.0, 0.0]], T_pj=_tf(cart_p),
            mass=0.75, com=[0.0, 0.0, 0.0],
            moment=_box(0.75, [0.2, 0.05, 0.05]),
        ),
        dict(
            type="revolute", name="j_pole", body_name="pole", parent=0,
            axes=[[0.0, 0.0, 1.0]], T_pj=_tf(pole_p - cart_p),
            mass=0.025, com=[0.0, 0.15, 0.0],
            moment=_box(0.025, [0.02, 0.3, 0.02]),
            damping=0.1,
        ),
        dict(
            type="revolute", name="j_pole2", body_name="pole2", parent=1,
            axes=[[0.0, 0.0, 1.0]], T_pj=_tf(pole2_p - pole_p),
            mass=0.025, com=[0.0, 0.15, 0.0],
            moment=_box(0.025, [0.02, 0.3, 0.02]),
            damping=0.1,
        ),
        dict(
            type="weld", name="j_con", body_name="weight", parent=2,
            T_pj=_tf(weight_p - pole2_p),
            mass=0.3, com=[0.0, 0.0, 0.0],
            moment=_box(0.3, [0.08, 0.04, 0.08]),
        ),
    ]
    return build_model(joints, dt=dt, actuated=(0,), dtype=dtype, device=device)


def cartpole(
    dt: float = 0.02, dtype: Optional[torch.dtype] = None, device="cuda",
) -> Model:
    """Prismatic cart + revolute pole (axis -z), both with damping 1.0 and
    position limits; the cart force is the only action."""
    joints = [
        dict(
            type="prismatic", name="j_cart", body_name="cart", parent=-1,
            axes=[[1.0, 0.0, 0.0]],
            mass=9.42477796, com=[0.0, 0.0, 0.0],
            moment=_capsule(9.42477796, 0.1, 0.2),
            damping=1.0, q_lower=-1.0, q_upper=1.0,
        ),
        dict(
            type="revolute", name="j_pole", body_name="pole", parent=0,
            axes=[[0.0, 0.0, -1.0]],
            mass=4.8953899, com=[0.0, 0.3, 0.0],
            moment=_capsule(4.8953899, 0.049, 0.6),
            damping=1.0, q_lower=-1.57, q_upper=1.57,
        ),
    ]
    return build_model(joints, dt=dt, actuated=(0,), dtype=dtype, device=device)
