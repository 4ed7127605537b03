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
``classify_lane``, ``lcp_residual`` and ``boxed_lcp`` with
``jacobi_solve``, ``staged_solve`` and ``boxed_lcp`` with every method of
the JAX package: "direct", "gs" (``pgs_solve``; the CUDA kernel K7,
``ops/cuda_lcp.pgs_batched``, on CUDA tensors), "jacobi" and "staged"
(its PGS stages through K7 likewise), and its implicit active-set
derivative (``_boxed_lcp_jvp``, forward and reverse: the
``torch.autograd.Function`` ``_ImplicitLCP``), whatever the method.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nimblephysics_tpu_torch.ops.linalg_small import inv_spd, solve_spd

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


# Up to this many rows pgs_solve sums each row's products one by one from
# j = 0 (K7's order at the worm's m = 28); above it, as the JAX package
# does past its own unrolled size, a row is one product and one sum, and
# the sweep's eager operations stay ~10 per row (the catapult's m = 129).
_PGS_SEQUENTIAL_ROWS = 32


def pgs_solve(A, b, lo_const, hi_const, fscale, x0, findex: Tuple[int, ...],
              iters: int = 60):
    """Projected Gauss-Seidel, fixed sweep count, warm-startable."""
    m = b.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = torch.where(diag.abs() > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    if m > _PGS_SEQUENTIAL_ROWS:
        return _pgs_rows(A, b, lo_const, hi_const, fscale, x0 + 0.0 * b, inv_diag, findex, iters)
    x = list((x0 + 0.0 * b).unbind(-1))
    # the rows and entries as views, taken once; a row's products A_ij x_j
    # in one multiplication, summed from j = 0 up as a sequential sum
    rows = A.unbind(-2)
    b_i, inv_i, lo_i, hi_i, fs_i = (t.unbind(-1) for t in (b, inv_diag, lo_const, hi_const,
                                                           fscale))
    for _ in range(iters):
        for i in range(m):
            prod = (rows[i] * torch.stack(x, dim=-1)).unbind(-1)
            acc = prod[0]
            for j in range(1, m):
                acc = acc + prod[j]
            xi = x[i] - (acc - b_i[i]) * inv_i[i]
            f = findex[i]
            if f >= 0:
                f_hi = fs_i[i] * torch.clamp(x[f], min=0.0)
                x[i] = torch.clamp(xi, -f_hi, f_hi)
            else:
                x[i] = torch.clamp(xi, lo_i[i], hi_i[i])
    return torch.stack(x, dim=-1)


def _pgs_rows(A, b, lo_const, hi_const, fscale, x, inv_diag, findex, iters):
    """pgs_solve's sweeps with x kept whole: row i is one product with A's
    row and one sum, and x_i is replaced by a select (the rows and entries
    as views, taken once)."""
    m = b.shape[-1]
    onehot = torch.eye(m, dtype=torch.bool, device=b.device).unbind(0)
    rows = A.unbind(-2)
    b_i, inv_i, lo_i, hi_i, fs_i = (t.unbind(-1) for t in (b, inv_diag, lo_const, hi_const,
                                                           fscale))
    for _ in range(iters):
        for i in range(m):
            xi = x[..., i] - ((rows[i] * x).sum(-1) - b_i[i]) * inv_i[i]
            f = findex[i]
            if f >= 0:
                f_hi = fs_i[i] * torch.clamp(x[..., f], min=0.0)
                xi = torch.clamp(xi, -f_hi, f_hi)
            else:
                xi = torch.clamp(xi, lo_i[i], hi_i[i])
            x = torch.where(onehot[i], xi[..., None], x)
    return x


def jacobi_solve(A, b, lo_const, hi_const, fscale, x0, findex: Tuple[int, ...],
                 iters: int = 10):
    """Projected Jacobi: every row from the previous iterate at once, the
    friction bounds from its normal impulses."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = torch.where(diag.abs() > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    x = x0 + 0.0 * b
    coupled, gather = _coupling(findex, b.device)
    for _ in range(iters):
        xi = x - (_mv(A, x) - b) * inv_diag
        f_hi = fscale * torch.clamp(x[..., gather], min=0.0)
        x = torch.clamp(xi, torch.where(coupled, -f_hi, lo_const),
                        torch.where(coupled, f_hi, hi_const))
    return x


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


def _implicit_parts(A, x, lo_const, hi_const, fscale, findex: Tuple[int, ...]):
    """The classes of a converged solution as the implicit rule uses them:
    (R, cmask, Qf) with x = R x_C on fixed classes, cmask the clamping rows
    and Qf = A[C, :] R padded to the identity off the clamping set."""
    m = x.shape[-1]
    dtype = x.dtype
    clamping, upper, s = _classify(x, lo_const, hi_const, fscale, findex)
    eye = torch.eye(m, dtype=dtype, device=x.device)
    gov = torch.zeros((m, m), dtype=dtype, device=x.device)
    for i, f in enumerate(findex):
        if f >= 0:
            gov[i, f] = 1.0
    S = (upper.to(dtype) * s)[..., :, None] * gov
    cmask = clamping.to(dtype)
    R = (eye + S) * cmask[..., None, :]
    Qf = (cmask[..., :, None] * (A @ R) * cmask[..., None, :]
          + torch.diag_embed(1.0 - cmask))
    return R, cmask, Qf


def _qf_solver(Qf):
    """The map rhs -> dx_C of ``_boxed_lcp_jvp`` and its transpose: up to
    24 rows the regularized normal equations through the pivot-free SPD
    inverse (eps scaled to the dtype and to max |Qf|), above a
    pseudoinverse truncated at ``_pinv_rtol``. Both depend on the primal
    Qf only, so the rule stays linear in the tangents."""
    m = Qf.shape[-1]
    dtype = Qf.dtype
    QfT = Qf.transpose(-1, -2)
    if m <= 24:
        eye = torch.eye(m, dtype=dtype, device=Qf.device)
        qscale = torch.clamp(torch.amax(Qf.abs(), dim=(-2, -1)), min=1.0)
        Mi = inv_spd(QfT @ Qf + (_eps(dtype) * qscale * qscale)[..., None, None] * eye)
        return (lambda r: _mv(Mi, _mv(QfT, r)),
                lambda g: _mv(Qf, _mv(Mi.transpose(-1, -2), g)))
    P = torch.linalg.pinv(Qf, rtol=_pinv_rtol(dtype))
    return lambda r: _mv(P, r), lambda g: _mv(P.transpose(-1, -2), g)


def _broadcast(A, *vecs, lead=()):
    """A (..., m, m) and the vectors (..., m) expanded to one batch shape
    behind ``lead``, the dimensions every one of them already has in
    front."""
    k = len(lead)
    batch = torch.broadcast_shapes(A.shape[k:-2], *(v.shape[k:-1] for v in vecs))

    def fit(t, tail):
        own = t.dim() - k - tail
        t = t.reshape(t.shape[:k] + (1,) * (len(batch) - own) + t.shape[k:])
        return t.expand(lead + batch + t.shape[t.dim() - tail:])

    return (fit(A, 2),) + tuple(fit(v, 1) for v in vecs)


def _pgs(A, b, lo_const, hi_const, fscale, x0, findex, iters, kernels):
    """PGS on one batch of LCPs: through K7's wrapper when ``kernels``,
    else ``pgs_solve``."""
    if kernels:
        # imported here: ops/cuda_lcp.py imports this module
        from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched
        return pgs_batched(*_broadcast(A, b, lo_const, hi_const, fscale, x0), findex,
                           iters=iters)
    return pgs_solve(A, b, lo_const, hi_const, fscale, x0, findex, iters=iters)


def staged_solve(A, b, lo_const, hi_const, fscale, x0, findex: Tuple[int, ...],
                 iters: int = 60, tol: float = 1e-8, kernels: bool = False):
    """The residual-gated cascade of the JAX package's ``staged_solve``:

      1. PGS at ``iters`` sweeps from x0;
      2. where the residual exceeds ``tol``: PGS on from there at 10 x
         ``iters``, kept where it lowers the residual;
      3. where it still exceeds 10 ``tol``: the direct active-set solve
         with the friction bounds frozen at the current normal impulses
         (8 rounds), then PGS at ``iters`` with the coupling live, kept
         where it lowers the residual.

    Each LCP is solved as the JAX package solves it alone; stages 2 and 3
    run only on the LCPs whose gate fires (``lax.cond`` per world, which
    JAX's vmap turns into a select over all of them). The PGS stages go
    through K7's wrapper when ``kernels``. ``staged_solve.gated`` holds
    the number of LCPs that entered stages 2 and 3 on the last call."""
    A, b, lo_const, hi_const, fscale, x0 = _broadcast(A, b, lo_const, hi_const, fscale, x0)
    batch, m = b.shape[:-1], b.shape[-1]
    A = A.reshape(-1, m, m)
    b, lo_const, hi_const, fscale, x0 = (t.reshape(-1, m) for t in (b, lo_const, hi_const,
                                                                    fscale, x0))
    coupled, gather = _coupling(findex, b.device)

    def residual(lcp, x):
        return lcp_residual(lcp[0], x, *lcp[1:], findex)

    def deep(lcp, x):
        return _pgs(*lcp, x, findex, 10 * iters, kernels)

    def direct(lcp, x):
        A_, b_, lo_, hi_, fs_ = lcp
        f_hi = fs_ * torch.clamp(x[..., gather], min=0.0)
        xd = direct_boxed_solve(A_, b_, torch.where(coupled, -f_hi, lo_),
                                torch.where(coupled, f_hi, hi_), rounds=8)
        return _pgs(*lcp, xd, findex, iters, kernels)

    every = (A, b, lo_const, hi_const, fscale)
    x = _pgs(*every, x0, findex, iters, kernels)
    r = residual(every, x)
    gated = []
    for stage, gate in ((deep, tol), (direct, 10 * tol)):
        idx = torch.nonzero(r > gate)[:, 0]
        gated.append(int(idx.numel()))
        if not gated[-1]:
            continue
        lcp = tuple(t[idx] for t in every)
        x_s = stage(lcp, x[idx])
        r_s = residual(lcp, x_s)
        better = r_s < r[idx]
        x = x.index_copy(0, idx, torch.where(better[:, None], x_s, x[idx]))
        r = r.index_copy(0, idx, torch.where(better, r_s, r[idx]))
    staged_solve.gated = tuple(gated)
    return x.reshape(batch + (m,))


staged_solve.gated = (0, 0)


def _solve(A, b, lo_const, hi_const, fscale, x0, findex, iters, method, kernels):
    if method == "direct":
        if not bool((hi_const > lo_const).any()):
            # every row boxed to [0, 0] (the limit rows of a step inside its
            # limits): 0 is the only solution, which the direct solve returns
            # too after ~1,000 launches (scripts/torch_step_op_count.py)
            return torch.zeros_like(_broadcast(A, b, lo_const, hi_const)[1])
        return direct_boxed_solve(A, b, lo_const, hi_const, rounds=min(iters, 4))
    if method == "staged":
        return staged_solve(A, b, lo_const, hi_const, fscale, x0, findex, iters,
                            kernels=kernels)
    if method == "jacobi":
        return jacobi_solve(A, b, lo_const, hi_const, fscale, x0, findex, iters)
    return _pgs(A, b, lo_const, hi_const, fscale, x0, findex, iters, kernels)


class _ImplicitLCP(torch.autograd.Function):
    """x = boxed LCP solve, with the implicit active-set derivative of the
    JAX package's ``_boxed_lcp_jvp`` instead of the solver's iterations:

        classes fixed:  x = R x_C,   Q x_C = b_C,   Q = A[C, :] R
        dx = R Qf^+ P_C^T (db - dA x)

    Forward mode applies that map; reverse mode its exact transpose,
    gb = P_C Qf^+T R^T g, giving b the cotangent gb and A -gb x^T. lo, hi,
    fscale and x0 get none, as in the JAX package.

    The solve always runs on plain tensors: under ``torch.func.vmap`` the
    ``vmap`` rule folds the vmapped dimension into the LCP batch and solves
    it in one call (K7 on the card), and under ``jvp``/``jacfwd`` a
    direction's tangent never reaches the solver: the primal is solved once
    and the rule alone is vmapped over the directions."""

    @staticmethod
    def forward(A, b, lo_const, hi_const, fscale, x0, findex, iters, method, kernels):
        args = (t.detach() for t in (A, b, lo_const, hi_const, fscale, x0))
        return _solve(*args, findex, iters, method, kernels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _, lo_const, hi_const, fscale, _, findex = inputs[:7]
        ctx.findex = findex
        ctx.save_for_forward(A, lo_const, hi_const, fscale, output)
        ctx.save_for_backward(A, lo_const, hi_const, fscale, output)

    @staticmethod
    def jvp(ctx, dA, db, *_):
        A, lo_const, hi_const, fscale, x = ctx.saved_tensors
        R, cmask, Qf = _implicit_parts(A, x, lo_const, hi_const, fscale, ctx.findex)
        rhs = torch.zeros_like(x) if db is None else db
        if dA is not None:
            rhs = rhs - _mv(dA, x)
        apply, _ = _qf_solver(Qf)
        return _mv(R, cmask * apply(cmask * rhs))

    @staticmethod
    def backward(ctx, g):
        A, lo_const, hi_const, fscale, x = ctx.saved_tensors
        R, cmask, Qf = _implicit_parts(A, x, lo_const, hi_const, fscale, ctx.findex)
        _, apply_t = _qf_solver(Qf)
        gb = cmask * apply_t(cmask * _mv(R.transpose(-1, -2), g))
        gA = -gb[..., :, None] * x[..., None, :]
        return gA, gb, None, None, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, A, b, lo_const, hi_const, fscale, x0, findex, iters, method,
             kernels):
        n = info.batch_size
        args = [t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
                for t, d in zip((A, b, lo_const, hi_const, fscale, x0), in_dims)]
        return _ImplicitLCP.apply(*_broadcast(*args, lead=(n,)), findex, iters, method,
                                  kernels), 0


def boxed_lcp(A, b, lo_const, hi_const, fscale, x0, findex: Tuple[int, ...],
              iters: int = 60, method: str = "gs", kernels: bool = True):
    """Solve the boxed LCP, differentiable by the implicit active-set rule
    (``_ImplicitLCP``), forward and reverse, under ``torch.func`` too.
    ``method="gs"`` runs ``iters`` projected Gauss-Seidel sweeps from x0
    with friction coupling: through K7's wrapper ``ops/cuda_lcp.pgs_batched``
    when ``kernels`` (the kernel on CUDA tensors, where it launches or
    raises; its plain version on CPU tensors), else ``pgs_solve``.
    ``"direct"`` runs the direct active-set solve (no friction coupling,
    ``min(iters, 4)`` rounds), ``"jacobi"`` ``iters`` projected Jacobi
    iterations and ``"staged"`` the residual-gated cascade
    (``staged_solve``, its PGS stages through K7's wrapper when
    ``kernels``)."""
    if method not in ("gs", "direct", "jacobi", "staged"):
        raise ValueError(f"boxed_lcp: unknown method {method!r}")
    return _ImplicitLCP.apply(A, b, lo_const, hi_const, fscale, x0, tuple(findex), int(iters),
                              method, bool(kernels))
