"""Boxed LCP for the joint-limit and Coulomb rows: the direct active-set
solve, its lane form, projected Gauss-Seidel, classification and residual.

PyTorch counterpart of ``nimblephysics_tpu/ops/lcp.py``: find x with

    w = A x - b,   lo_i <= x_i <= hi_i,
    x_i = lo_i  =>  w_i >= 0,   x_i = hi_i  =>  w_i <= 0,
    lo_i < x_i < hi_i  =>  w_i = 0,

friction rows bounded by their governing normal impulse (``findex``, a
static tuple, -1 for uncoupled rows). Every function takes leading batch
dimensions (A (..., m, m), vectors (..., m)): the JAX package vmaps its
per-world functions, the port writes the batch out.

Ported: ``pgs_solve``, ``direct_boxed_solve`` (pseudoinverse rounds, PGS
polish, exact polish), ``direct_boxed_solve_lane`` (the form the
class-rollout kernel runs, ``csrc/step.cuh``), ``_classify`` /
``classify_lane``, ``lcp_residual`` and ``boxed_lcp`` forward with
``method="direct"`` and ``method="gs"`` (``pgs_solve``; the CUDA kernel K7,
``ops/cuda_lcp.pgs_batched``, on CUDA tensors). The implicit active-set
derivative of ``boxed_lcp`` (``_boxed_lcp_jvp``) and the
``jacobi``/``staged`` methods are ROADMAP queue A, M4.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nimblephysics_tpu_torch.ops.linalg_small import solve_spd

_BIG = 1e20
# Reference: ConstrainedGroupGradientMatrices.cpp:24
CLAMPING_THRESHOLD = 1e-6


def _pinv_rtol(dtype) -> float:
    """Pseudoinverse truncation scaled to the dtype: singular values at the
    dtype's noise floor are truncated, not inverted."""
    return 1e-12 if dtype == torch.float64 else 3e-6


def _tol(dtype) -> float:
    return 1e-10 if dtype == torch.float64 else 1e-6


def _eps(dtype) -> float:
    return 1e-10 if dtype == torch.float64 else 1e-5


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _coupling(findex: Tuple[int, ...], device):
    coupled = torch.tensor([f >= 0 for f in findex], dtype=torch.bool, device=device)
    gather = torch.tensor([max(f, 0) for f in findex], dtype=torch.long, device=device)
    return coupled, gather


def _comp_residual(A, b, lo, hi, x, tol):
    """Complementarity violation of an in-box iterate, max over rows with
    an initial 0 (NaN propagates)."""
    w = _mv(A, x) - b
    at_lo = x <= lo + tol
    at_hi = x >= hi - tol
    r = torch.where(at_lo, torch.clamp(-w, min=0.0),
                    torch.where(at_hi, torch.clamp(w, min=0.0), w.abs()))
    return torch.clamp(torch.amax(r, dim=-1), min=0.0)


def pgs_solve(A, b, lo_const, hi_const, fscale, x0, findex: Tuple[int, ...],
              iters: int = 60):
    """Projected Gauss-Seidel, fixed sweep count, warm-startable."""
    m = b.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = torch.where(diag.abs() > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    x = list((x0 + 0.0 * b).unbind(-1))
    for _ in range(iters):
        for i in range(m):
            resid = sum(A[..., i, j] * x[j] for j in range(m)) - b[..., i]
            xi = x[i] - resid * inv_diag[..., i]
            f = findex[i]
            if f >= 0:
                f_hi = fscale[..., i] * torch.clamp(x[f], min=0.0)
                lo_i, hi_i = -f_hi, f_hi
            else:
                lo_i, hi_i = lo_const[..., i], hi_const[..., i]
            x[i] = torch.clamp(xi, lo_i, hi_i)
    return torch.stack(x, dim=-1)


def _classes(x, xn, coupled, lo_const, hi_const, fscale):
    normal_clamp = (~coupled) & (x > CLAMPING_THRESHOLD) & (hi_const > _BIG / 2)
    f_bound = fscale * torch.clamp(xn, min=0.0)
    fric_active = coupled & (xn > CLAMPING_THRESHOLD)
    at_bound = (x.abs() - f_bound).abs() <= CLAMPING_THRESHOLD * torch.clamp(f_bound, min=1.0)
    fric_clamp = fric_active & ~at_bound
    fric_upper = fric_active & at_bound
    # bounded non-friction rows (joint limits): clamping strictly inside
    bounded = (~coupled) & (hi_const < _BIG / 2)
    inside = (x > lo_const + CLAMPING_THRESHOLD) & (x < hi_const - CLAMPING_THRESHOLD)
    # bilateral equality rows: always clamping
    bilateral = (~coupled) & (lo_const < -_BIG / 2) & (hi_const > _BIG / 2)
    clamping = normal_clamp | fric_clamp | (bounded & inside) | bilateral
    return clamping, fric_upper, torch.sign(x) * fscale


def _classify(x, lo_const, hi_const, fscale, findex: Tuple[int, ...]):
    """Per-row class masks of a converged solution: (clamping, upper,
    upper_sign). clamping: the constraint holds with equality; upper:
    friction riding the cone surface, x = s x_n; upper_sign = sign(x)
    fscale."""
    coupled, gather = _coupling(findex, x.device)
    return _classes(x, x[..., gather], coupled, lo_const, hi_const, fscale)


def classify_lane(x, lo_const, hi_const, fscale, findex: Tuple[int, ...]):
    """``_classify`` with the friction-coupling gather unrolled over the
    static findex (the form the class-rollout kernel runs); the same
    values."""
    xn = torch.stack([x[..., max(f, 0)] for f in findex], dim=-1)
    coupled = torch.tensor([f >= 0 for f in findex], dtype=torch.bool, device=x.device)
    return _classes(x, xn, coupled, lo_const, hi_const, fscale)


def direct_boxed_solve(A, b, lo_const, hi_const, rounds: int = 3,
                       polish_sweeps: int = 16):
    """Direct active-set solve for boxed LCPs without friction coupling
    (joint limits, Coulomb rows): ``rounds`` of {solve the interior
    subsystem by pseudoinverse, project, reclassify}, keeping the
    best-residual iterate; then a PGS polish from it and one exact solve on
    its active set, kept when it lowers the residual."""
    m = b.shape[-1]
    dtype = b.dtype
    eye = torch.eye(m, dtype=dtype, device=b.device)
    tol = _tol(dtype)
    interior = torch.ones_like(b) > 0.0
    x = torch.zeros_like(b)
    best_x = torch.clamp(x, lo_const, hi_const)
    best_res = _comp_residual(A, b, lo_const, hi_const, best_x, tol)
    for _ in range(rounds):
        i_mask = interior.to(dtype)
        x_bound = torch.clamp(x, lo_const, hi_const) * (1.0 - i_mask)
        rhs = i_mask * (b - _mv(A, x_bound))
        Af = i_mask[..., :, None] * A * i_mask[..., None, :] + eye * (1.0 - i_mask)[..., None, :]
        x_int = _mv(torch.linalg.pinv(Af, rtol=_pinv_rtol(dtype)), rhs)
        x_new = x_int * i_mask + x_bound
        w = _mv(A, x_new) - b
        below = x_new <= lo_const
        above = x_new >= hi_const
        x = torch.clamp(x_new, lo_const, hi_const)
        want_in = (below & (w < 0.0)) | (above & (w > 0.0))
        interior = (~below & ~above) | want_in
        res = _comp_residual(A, b, lo_const, hi_const, x, tol)
        better = res < best_res
        best_x = torch.where(better[..., None], x, best_x)
        best_res = torch.where(better, res, best_res)
    if polish_sweeps > 0:
        best_x = pgs_solve(A, b, lo_const, hi_const, torch.zeros_like(b), best_x,
                           (-1,) * m, iters=polish_sweeps)
    ip = ((best_x > lo_const + tol) & (best_x < hi_const - tol)).to(dtype)
    xb = torch.clamp(best_x, lo_const, hi_const) * (1.0 - ip)
    rhs_p = ip * (b - _mv(A, xb))
    Afp = ip[..., :, None] * A * ip[..., None, :] + eye * (1.0 - ip)[..., None, :]
    x_pol = torch.clamp(solve_spd(Afp, rhs_p) * ip + xb, lo_const, hi_const)
    better_p = (_comp_residual(A, b, lo_const, hi_const, x_pol, tol)
                < _comp_residual(A, b, lo_const, hi_const, best_x, tol))
    return torch.where(better_p[..., None], x_pol, best_x)


def direct_boxed_solve_lane(A, b, lo_const, hi_const, rounds: int = 3,
                            polish_sweeps: int = 8):
    """The form of ``direct_boxed_solve`` the class-rollout kernel runs:
    the same rounds, each interior subsystem solved by regularized normal
    equations through the pivot-free SPD solve, and a PGS polish whose row
    update is x + e_i (x_i' - x_i)."""
    m = b.shape[-1]
    dtype = b.dtype
    eye = torch.eye(m, dtype=dtype, device=b.device)
    eps, tol = _eps(dtype), _tol(dtype)

    def subsolve(i_mask, x):
        x_bound = torch.clamp(x, lo_const, hi_const) * (1.0 - i_mask)
        rhs = i_mask * (b - _mv(A, x_bound))
        Af = i_mask[..., :, None] * A * i_mask[..., None, :] + eye * (1.0 - i_mask)[..., None, :]
        scale = torch.clamp(torch.amax(Af.abs(), dim=(-2, -1)), min=1.0)
        AfT = Af.transpose(-1, -2)
        AtA = AfT @ Af + (eps * scale * scale)[..., None, None] * eye
        x_int = solve_spd(AtA, _mv(AfT, rhs))
        return x_int * i_mask + x_bound

    interior = torch.ones_like(b) > 0.0
    x = torch.zeros_like(b)
    best_x = torch.clamp(x, lo_const, hi_const)
    best_res = _comp_residual(A, b, lo_const, hi_const, best_x, tol)
    for _ in range(rounds):
        x_new = subsolve(interior.to(dtype), x)
        w = _mv(A, x_new) - b
        below = x_new <= lo_const
        above = x_new >= hi_const
        x = torch.clamp(x_new, lo_const, hi_const)
        want_in = (below & (w < 0.0)) | (above & (w > 0.0))
        interior = (~below & ~above) | want_in
        res = _comp_residual(A, b, lo_const, hi_const, x, tol)
        better = res < best_res
        best_x = torch.where(better[..., None], x, best_x)
        best_res = torch.where(better, res, best_res)
    x = best_x
    diag = (A * eye).sum(-1)
    inv_diag = torch.where(diag.abs() > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    for _ in range(polish_sweeps):
        for i in range(m):
            resid = (A[..., i, :] * x).sum(-1) - b[..., i]
            xi = torch.clamp(x[..., i] - resid * inv_diag[..., i],
                             lo_const[..., i], hi_const[..., i])
            x = x + eye[i] * (xi - x[..., i])[..., None]
    better = _comp_residual(A, b, lo_const, hi_const, x, tol) < best_res
    return torch.where(better[..., None], x, best_x)


def lcp_residual(A, x, b, lo_const, hi_const, fscale, findex: Tuple[int, ...]):
    """Boxed-complementarity residual of a candidate solution with the
    friction-coupled bounds resolved: the max violation, 0 for an exact
    solution."""
    coupled, gather = _coupling(findex, x.device)
    f_hi = fscale * torch.clamp(x[..., gather], min=0.0)
    lo_i = torch.where(coupled, -f_hi, lo_const)
    hi_i = torch.where(coupled, f_hi, hi_const)
    w = _mv(A, x) - b
    # the boundary tolerance scales with the impulses only (hi holds the
    # +-1e20 sentinels)
    tol = _tol(b.dtype) * torch.clamp(torch.amax(x.abs(), dim=-1, keepdim=True), min=1.0)
    at_lo = x <= lo_i + tol
    at_hi = x >= hi_i - tol
    r = torch.where(at_lo, torch.clamp(-w, min=0.0),
                    torch.where(at_hi, torch.clamp(w, min=0.0), w.abs()))
    oob = torch.clamp(lo_i - x, min=0.0) + torch.clamp(x - hi_i, min=0.0)
    return torch.clamp(torch.amax(r + oob, dim=-1), min=0.0)


class _ForwardOnlyLCP(torch.autograd.Function):
    """A boxed-LCP solve as a function with no derivative: the implicit
    active-set rule is not ported yet, and autograd through the solver's
    iterations would give the derivative of the iteration instead."""

    @staticmethod
    def forward(solve, *args):
        return solve(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the implicit derivative of boxed_lcp is not ported yet (ROADMAP "
            "queue A, M4)")

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "the implicit derivative of boxed_lcp is not ported yet (ROADMAP "
            "queue A, M4)")


def boxed_lcp(A, b, lo_const, hi_const, fscale, x0, findex: Tuple[int, ...],
              iters: int = 60, method: str = "gs", kernels: bool = True):
    """Solve the boxed LCP, forward only: ``method="gs"`` runs ``iters``
    projected Gauss-Seidel sweeps from x0 with friction coupling (on CUDA
    tensors the kernel K7 when ``kernels``, else ``pgs_solve``);
    ``"direct"`` the direct active-set solve (no friction coupling,
    ``min(iters, 4)`` rounds)."""
    if method == "direct":
        return _ForwardOnlyLCP.apply(
            lambda *a: direct_boxed_solve(*a[:4], rounds=a[4]), A, b, lo_const, hi_const,
            min(iters, 4))
    if method == "gs":
        if kernels and b.is_cuda:
            from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched as solve
        else:
            solve = pgs_solve
        return _ForwardOnlyLCP.apply(
            lambda *a: solve(*a[:6], findex, iters=a[6]), A, b, lo_const, hi_const, fscale,
            x0, iters)
    raise NotImplementedError(
        f"boxed_lcp(method={method!r}) is not ported yet (ROADMAP queue A, M4: jacobi "
        "and staged)")
