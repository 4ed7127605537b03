"""Pivot-free Gauss-Jordan inverse of small SPD matrices.

PyTorch counterpart of ``nimblephysics_tpu/ops/linalg_small.py``. It is the
plain form of the elimination inside the Riccati kernel
(``csrc/riccati.cu``): every matrix inverted here is SPD (the articulated
joint inertia in ABA, Quu in the backward pass), so no pivoting is needed,
and the smallest pivot certifies positive definiteness (the k-th pivot of
a symmetric matrix is det(A_k)/det(A_{k-1})).
"""

from __future__ import annotations

from typing import Tuple

import torch


def inv_spd_pivots(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A^-1, min pivot) for SPD A (..., n, n)."""
    # pivots keep a trailing axis: under torch.func's forward mode a 0-dim
    # tensor divided into a Python float is promoted to float64
    n = A.shape[-1]
    if n == 1:
        piv = A[..., 0:1, 0:1]
        return 1.0 / piv, piv[..., 0, 0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    # rows of the augmented [A | I], eliminated one pivot at a time
    rows = [
        torch.cat([A[..., k, :], torch.zeros_like(A[..., k, :]) + eye[k]], dim=-1)
        for k in range(n)
    ]
    min_piv = None
    for k in range(n):
        piv = rows[k][..., k:k + 1]
        min_piv = piv if min_piv is None else torch.minimum(min_piv, piv)
        prow = rows[k] * (1.0 / piv)
        rows = [
            prow if i == k else rows[i] - rows[i][..., k:k + 1] * prow
            for i in range(n)
        ]
    return torch.stack([r[..., n:] for r in rows], dim=-2), min_piv[..., 0]


def inv_spd(A: torch.Tensor) -> torch.Tensor:
    return inv_spd_pivots(A)[0]


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for SPD A (..., n, n) with b (..., n) or (..., n, k)."""
    Ai = inv_spd(A)
    if b.dim() == A.dim() - 1:
        return (Ai @ b[..., None])[..., 0]
    return Ai @ b
