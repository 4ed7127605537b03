"""Programmatic builders for the benchmark worlds.

PyTorch counterpart of ``pendulum``, ``inverted_double_pendulum``,
``cartpole``, ``catapult`` and ``jump_worm`` in
``nimblephysics_tpu/models/builders.py``. The leaves are computed in
float64 exactly as the JAX package computes them and then cast to
``dtype`` on ``device``.
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


def catapult(
    dt: float = 0.002, dtype: Optional[torch.dtype] = None, device="cuda",
) -> Model:
    """A 2D projectile (translational2d, unactuated) carrying a box, and a
    3-link tail on a welded root, each link revolute about z, limited to
    [0, pi] and actuated; a box on the last link and a floor halfspace
    (top surface y = -0.575)."""
    joints = [
        dict(
            type="translational2d", name="projectile_joint",
            body_name="projectile", parent=-1,
            axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
            mass=1.0, tau_lower=0.0, tau_upper=0.0,
        ),
        dict(
            type="weld", name="root_joint", body_name="root", parent=-1,
            T_pj=_tf([0.5, -0.45, 0.0]), mass=1.0,
        ),
    ]
    parent = 1
    for k in range(3):
        joints.append(
            dict(
                type="revolute", name=f"tail{k}_joint", body_name=f"tail{k}",
                parent=parent, axes=[[0.0, 0.0, 1.0]],
                T_pj=_tf([0.0, 0.125, 0.0]) if k > 0 else _tf(),
                T_cj=_tf([0.0, -0.125, 0.0]),
                mass=1.0, tau_lower=-1000.0, tau_upper=1000.0,
                q_lower=0.0, q_upper=np.pi,
            )
        )
        parent = 2 + k
    shapes = (
        dict(kind="box", body_index=0, params=[0.1, 0.1, 0.1, 0.0]),
        dict(kind="box", body_index=4, params=[0.05, 0.25, 0.05, 0.0]),
        # the floor box at (0, -0.7, 0), height 0.25, as the halfspace
        # y >= -0.575 under the projectile's flight
        dict(kind="halfspace", body_index=-1, params=[0.0, 1.0, 0.0, -0.575]),
    )
    return build_model(joints, dt=dt, shapes=shapes, actuated=(2, 3, 4), dtype=dtype,
                       device=device)


def jump_worm(
    dt: float = 0.001, dtype: Optional[torch.dtype] = None, device="cuda",
) -> Model:
    """A 2D root (translational2d in x and y) carrying a box, and two
    revolute links limited to [0, pi], over a floor halfspace (top surface
    y = -0.575); the two link joints are the actions."""
    joints = [
        dict(
            type="translational2d", name="root_joint", body_name="root",
            parent=-1, axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
            mass=1.0, tau_lower=0.0, tau_upper=0.0,
        ),
        dict(
            type="revolute", name="pole1_joint", body_name="pole1", parent=0,
            axes=[[0.0, 0.0, 1.0]], T_cj=_tf([0.0, -0.125, 0.0]),
            mass=1.0, tau_lower=-100.0, tau_upper=100.0,
            q_lower=0.0, q_upper=np.pi,
        ),
        dict(
            type="revolute", name="pole2_joint", body_name="pole2", parent=1,
            axes=[[0.0, 0.0, 1.0]], T_pj=_tf([0.0, 0.125, 0.0]),
            T_cj=_tf([0.0, -0.125, 0.0]),
            mass=1.0, tau_lower=-100.0, tau_upper=100.0,
            q_lower=0.0, q_upper=np.pi,
        ),
    ]
    shapes = (
        dict(kind="box", body_index=0, params=[0.1, 0.1, 0.1, 0.0]),
        # floor box center (0, -0.7, 0), height 0.25: top surface y = -0.575
        dict(kind="halfspace", body_index=-1, params=[0.0, 1.0, 0.0, -0.575]),
    )
    return build_model(joints, dt=dt, shapes=shapes, actuated=(2, 3), dtype=dtype,
                       device=device)
