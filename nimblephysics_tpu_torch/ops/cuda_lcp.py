"""K7: batched boxed-LCP projected Gauss-Seidel with friction coupling.

Port of ``nimblephysics_tpu/ops/pallas_lcp.py :: pallas_pgs_batched``:
``vmap(pgs_solve)`` over a batch of LCPs, a fixed number of sweeps, rows
in order, friction rows bounded by +-fscale max(x[findex], 0).
``pgs_batched`` launches a CUDA kernel on CUDA tensors (one lane group
per LCP, its rows on the lanes, the residual kept current) and runs
``pgs_batched_plain`` (``ops/lcp.py`` ``pgs_solve`` on the batch) on CPU
tensors. It routes by m: up to one row per lane (the worm's 28) to
``csrc/lcp.cu``, whose lanes keep their rows of A in registers; above, to
``csrc/lcp_wide.cu``, whose block stages A in shared memory (the
catapult's 129). The port's ``boxed_lcp(method="gs")`` calls it,
so the pointwise classification of the contact replan
(``frozen_contact.classify_points``) solves its LCPs here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nimblephysics_tpu_torch.ops import _build
from nimblephysics_tpu_torch.ops.lcp import pgs_solve


# The most rows csrc/lcp.cu's register body takes: one row of A per lane.
REGISTER_ROWS_MAX = 32


def pgs_batched_plain(A, b, lo, hi, fscale, x0, findex: Tuple[int, ...], iters: int = 60):
    """``pgs_solve`` over the leading batch dimensions."""
    return pgs_solve(A, b, lo, hi, fscale, x0, findex, iters=iters)


def pgs_batched(A, b, lo, hi, fscale, x0, findex: Tuple[int, ...], iters: int = 60):
    """Batched PGS: A (..., m, m), b/lo/hi/fscale/x0 (..., m), findex a
    static tuple of m ints (-1 for uncoupled rows). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    name = "pgs_batched"
    dev, dtype = _build.check_inputs(
        name, dict(A=A, b=b, lo=lo, hi=hi, fscale=fscale, x0=x0))
    m = b.shape[-1]
    batch = b.shape[:-1]
    for key, t in (("lo", lo), ("hi", hi), ("fscale", fscale), ("x0", x0)):
        _build.check_shape(name, key, t, b.shape)
    _build.check_shape(name, "A", A, batch + (m, m))
    if len(findex) != m or any(not -1 <= f < m for f in findex):
        raise ValueError(f"{name}: findex must hold {m} row indices or -1")
    if dev.type == "cpu":
        return pgs_batched_plain(A, b, lo, hi, fscale, x0, findex, iters)
    n = b[..., 0].numel()
    flat = [t.reshape(n, m).contiguous() for t in (b, lo, hi, fscale, x0)]
    A_f = A.reshape(n, m, m).contiguous()
    fi = torch.tensor(findex, dtype=torch.int32, device=dev)
    x = torch.empty((n, m), dtype=dtype, device=dev)
    lib = _build.load()
    wide = m > REGISTER_ROWS_MAX
    launch = lib.nptt_pgs_wide if wide else lib.nptt_pgs
    rc = launch(int(dtype == torch.float64), m, n, int(iters), A_f.data_ptr(),
                *(t.data_ptr() for t in flat), fi.data_ptr(), x.data_ptr(),
                _build.stream_ptr(dev))
    _build.check(rc, name, f"m = {m}; " + ("csrc/lcp_wide.cu NPTT_PGS_WIDE_SIZES" if wide
                                           else "csrc/lcp.cu NPTT_PGS_SIZES"))
    pgs_batched.launches += 1
    return x.reshape(b.shape)


pgs_batched.launches = 0
