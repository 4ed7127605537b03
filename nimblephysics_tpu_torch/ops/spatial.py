"""Spatial (6D) inertias.

PyTorch counterpart of the parts of ``nimblephysics_tpu/ops/spatial.py``
that the builders need. A body's spatial inertia about its own frame
origin is

    I = [[ I_com + m c^ c^T,  m c^ ],
         [ m c^T,             m 1  ]]

with c the COM offset in the body frame and c^ = hat(c).
"""

from __future__ import annotations

import math

import torch

from nimblephysics_tpu_torch.ops.lie import Ad_inv, Transform, hat


def spatial_inertia(
    mass: torch.Tensor, com: torch.Tensor, moment: torch.Tensor
) -> torch.Tensor:
    """6x6 spatial inertia from mass (...,), com (..., 3) and the moment
    (..., 3, 3) about the COM."""
    C = hat(com)
    eye = torch.eye(3, dtype=moment.dtype, device=moment.device).expand(C.shape)
    m = mass[..., None, None]
    Ct = C.transpose(-1, -2)
    top = torch.cat([moment + m * (C @ Ct), m * C], dim=-1)
    bottom = torch.cat([m * Ct, m * eye], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _diag3(a, b, c) -> torch.Tensor:
    zero = torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack([a, zero, zero], dim=-1),
            torch.stack([zero, b, zero], dim=-1),
            torch.stack([zero, zero, c], dim=-1),
        ],
        dim=-2,
    )


def box_inertia(mass: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Solid box moment about the COM; ``size`` holds the full extents."""
    x2 = size[..., 0] * size[..., 0]
    y2 = size[..., 1] * size[..., 1]
    z2 = size[..., 2] * size[..., 2]
    c = mass / 12.0
    return _diag3(c * (y2 + z2), c * (x2 + z2), c * (x2 + y2))


def capsule_inertia(
    mass: torch.Tensor, radius: torch.Tensor, height: torch.Tensor
) -> torch.Tensor:
    """Capsule along z, ``height`` the cylinder length; the mass is split
    between the cylinder and the hemispheres by volume."""
    r, h = radius, height
    vol_cyl = math.pi * r * r * h
    vol_cap = 4.0 / 3.0 * math.pi * (r * r * r)
    vol = vol_cyl + vol_cap
    m_cyl = mass * vol_cyl / vol
    m_cap = mass * vol_cap / vol
    ixx = m_cyl * (h * h / 12.0 + r * r / 4.0)
    izz = m_cyl * r * r / 2.0
    i_sph = 0.4 * m_cap * r * r
    ixx = ixx + i_sph + m_cap * (h * h / 4.0 + 3.0 * h * r / 8.0)
    izz = izz + i_sph
    return _diag3(ixx, ixx, izz)


def transform_inertia(T: Transform, I: torch.Tensor) -> torch.Tensor:
    """Spatial inertia I of the child frame expressed in the parent frame of
    T: Ad(T^-1)^T I Ad(T^-1)."""
    X = Ad_inv(T)
    return X.transpose(-1, -2) @ I @ X
