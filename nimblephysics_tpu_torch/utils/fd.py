"""Finite-difference harness — the ground-truth oracle for every analytic
derivative, mirroring the reference's test philosophy
(`dart/math/FiniteDifference.hpp:19-57`, `unittests/GradientTestUtils.hpp`):
every analytical Jacobian ships with an FD twin and a tolerance test.

The port's own copy of ``nimblephysics_tpu/utils/fd.py``: plain numpy, so
the port never imports the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def fd_jacobian(f: Callable, x: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Central-difference Jacobian of f: R^n -> R^m, returns (m, n)."""
    x = np.asarray(x, dtype=np.float64)
    y0 = np.asarray(f(x), dtype=np.float64)
    out = np.zeros(y0.shape + x.shape, dtype=np.float64)
    for i in range(x.size):
        idx = np.unravel_index(i, x.shape)
        dx = np.zeros_like(x)
        dx[idx] = eps
        yp = np.asarray(f(x + dx), dtype=np.float64)
        ym = np.asarray(f(x - dx), dtype=np.float64)
        out[..., *idx] = (yp - ym) / (2 * eps)
    return out.reshape(y0.size, x.size)

