"""SO(3)/SE(3) helpers that the joints and the dynamics need.

PyTorch counterpart of ``nimblephysics_tpu/ops/lie.py`` (``hat``,
``expm_so3``, ``Transform`` and the ``Ad*`` helpers). Every function takes
leading batch dimensions and is free of data-dependent control flow, so it
also runs under ``torch.func`` transforms.

Conventions: spatial motion vectors are angular-first, V = (omega; v),
shape (..., 6); a transform T = (R, p) maps child-frame coordinates to the
parent frame, x_parent = R @ x_child + p.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Threshold on theta^2 under which Taylor series replace the trig formulas.
_SMALL_THETA_SQ = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, broadcasting the batch dimensions."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def _trig_coeffs(theta_sq: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe near 0."""
    small = theta_sq < _SMALL_THETA_SQ
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A_exact = sin_t / theta
    B_exact = (1.0 - cos_t) / safe_sq
    C_exact = (theta - sin_t) / (safe_sq * theta)
    A_taylor = 1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0
    B_taylor = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    C_taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    A = torch.where(small, A_taylor, A_exact)
    B = torch.where(small, B_taylor, B_exact)
    C = torch.where(small, C_taylor, C_exact)
    return A, B, C


def _eye3(like: torch.Tensor, batch=()) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        tuple(batch) + (3, 3)
    )


def expm_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: exp-map coordinates (..., 3) -> rotation (..., 3, 3)."""
    # theta^2 keeps a trailing axis: under torch.func's forward mode a
    # 0-dim tensor times a Python float is promoted to float64
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, _ = _trig_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye3(w, W.shape[:-2]) + A[..., None] * W + B[..., None] * W2


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _swap(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


class Transform(NamedTuple):
    """Rigid transform T = (R, p): x_parent = R @ x_child + p."""

    R: torch.Tensor
    p: torch.Tensor

    def compose(self, other: "Transform") -> "Transform":
        """self o other: first apply ``other``, then ``self``."""
        return Transform(R=self.R @ other.R, p=_matvec(self.R, other.p) + self.p)

    def inverse(self) -> "Transform":
        Rt = _swap(self.R)
        return Transform(R=Rt, p=-_matvec(Rt, self.p))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _matvec(self.R, x) + self.p

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        return _matvec(self.R, x)


def Ad(T: Transform) -> torch.Tensor:
    """6x6 motion adjoint of T: [[R, 0], [p^ R, R]]."""
    R, p = T.R, T.p
    ph_R = hat(p) @ R
    zero = torch.zeros_like(R)
    top = torch.cat([R, zero], dim=-1)
    bottom = torch.cat([ph_R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def Ad_inv(T: Transform) -> torch.Tensor:
    """Ad(T^-1): maps parent-frame motion to the child frame."""
    return Ad(T.inverse())


def ad_motion(V: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """V x_m W (motion cross product) in vector form."""
    w, v = V[..., :3], V[..., 3:]
    ww, wv = W[..., :3], W[..., 3:]
    return torch.cat([cross(w, ww), cross(v, ww) + cross(w, wv)], dim=-1)


def ad_dual(V: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """V x_f F = -ad(V)^T F (force cross product)."""
    w, v = V[..., :3], V[..., 3:]
    n, f = F[..., :3], F[..., 3:]
    return torch.cat([cross(w, n) + cross(v, f), cross(w, f)], dim=-1)


def Ad_inv_apply(T: Transform, V: torch.Tensor) -> torch.Tensor:
    """Ad(T^-1) @ V = (R^T w; R^T (v - p^ w))."""
    w, v = V[..., :3], V[..., 3:]
    Rt = _swap(T.R)
    return torch.cat([_matvec(Rt, w), _matvec(Rt, v - cross(T.p, w))], dim=-1)


def Ad_dual_apply(T: Transform, F: torch.Tensor) -> torch.Tensor:
    """Force child -> parent: Ad(T^-1)^T F = (R n + p^ R f; R f)."""
    n, f = F[..., :3], F[..., 3:]
    Rf = T.rotate(f)
    return torch.cat([T.rotate(n) + cross(T.p, Rf), Rf], dim=-1)
