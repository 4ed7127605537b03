#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nimblephysics_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card, after building the CUDA kernels
and holding each one against its plain PyTorch version:

  * the contact-free batched iLQR replan of ``bench.py``'s cartpole row
    (B=4096 worlds, H=100, 8 iterations, 6 alphas): kernels K1 (Riccati),
    K3 (linearize) and K2 (line-search rollout);
  * the joint-limit contact MPC replan of ``bench.py``'s cartpole_limits
    row, ``solve_contact_mpc_batch(class_refresh="rollout")`` (B=2048,
    H=100, 8 iterations, 6 alphas): kernels K6 (full-LCP class rollout),
    K4 (linearize of the frozen-class step), K2 on frozen classes and K1,
    on the stock cartpole (limits +-1 m, +-1.57 rad) and on a cartpole
    with narrowed limits (+-0.6 m, +-0.5 rad) started into them.

Phases:

  1. environment: torch, the card, its power limit (nvidia-smi);
  2. build: one nvcc call for all kernels (skipped when already built);
  3. K1-K3 against their plain versions at B=512, T=100, in f64
     (rel 1e-9) and f32 (rel 2e-4), and the Riccati kernel's second
     instance, (nx, na) = (6, 3); then each kernel at the contact-free
     path's shapes in f32 with kernel and plain times;
  4. the contact-free path at full width: f64 kernel path against the plain
     path on the card (cost within rel 1e-10; u within 1e-8 abs in every
     world where the plain path run from x0 +- 1e-13 moves u by less than
     that, and within twice that world's own move in the others; final
     cost <= initial cost in every world), then the f32 kernel path once
     with the launch counters set to 0 before and read after, three warm
     timed runs (solves/s) and one profiled solve;
  5. K6, K4 (PCG depth m + 6, 4 and 1; at 1 the PCG stops short where two
     rows clamp, so only the implicit tangent passes) and K2 with classes against their
     plain versions on the narrowed model at B=512, T=100: f64 rel 1e-9
     with identical classes; f32 rel 2e-4, where K6's classes may differ
     from the plain version's only at a world's first differing step and
     only where an impulse lies within 1e-4 of CLAMPING_THRESHOLD or q
     within 1e-5 of a limit (the count is printed; the world's later steps
     leave the comparison); then each at the contact path's shapes in f32
     (B=2048, T=100) with kernel and plain times;
  6. the contact path in f64, kernel path against plain path, narrowed
     model, B=256: costs rel 1e-10, u as in phase 4; besides, a world
     whose last accepted step improved the cost by less than rel 1e-12 in
     both paths (a step that rounding decides; the contact solve ends so in
     most worlds) passes when its two costs agree to rel 1e-14 (the count
     of worlds passed on each ground is printed);
  7. the contact path at full width in f32 on the stock and the narrowed
     cartpole: launch counts (K6 1, K2 9, K4 8, K1 8 per replan, K3 0),
     final cost <= initial cost in every world, the share of (world, step)
     points with a clamping row in the returned classes (>= 5% on the
     narrowed model), three warm timed replans (solves/s, replan ms), and
     one profiled replan (device-busy share, top kernels);
  8. a JSON line with every kernel's numbers, then the result line.

Exits non-zero without CUDA, and on any failure. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from nimblephysics_tpu_torch.models import builders
from nimblephysics_tpu_torch.models.model import relax_limits
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.ops.collide import detect_contacts
from nimblephysics_tpu_torch.ops.contact import build_constraint_system, lcp_dim, limited_dofs
from nimblephysics_tpu_torch.ops.cuda_linearize import (
    linearize,
    linearize_plain,
    linearize_split,
    linearize_split_plain,
)
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward, riccati_backward_plain
from nimblephysics_tpu_torch.ops.cuda_rollout import (
    rollout_classes,
    rollout_classes_plain,
    rollout_gains,
    rollout_gains_plain,
)
from nimblephysics_tpu_torch.ops.lcp import _BIG, CLAMPING_THRESHOLD, direct_boxed_solve_lane
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost
from nimblephysics_tpu_torch.trajectory.ilqr import (
    ILQRConfig,
    _cost_derivatives,
    ilqr_solve_batch,
    solve_contact_mpc_batch,
)

T_START = time.perf_counter()
SEED = 0
B_CHECK, B_FULL, H = 512, 4096, 100
ITERS = 8
ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01)
TOL = {"float64": 1e-9, "float32": 2e-4}
U_TOL_F64 = 1e-8
U_SENS_FACTOR = 2.0
X0_SHIFT = 1e-13
COST_RTOL_F64 = 1e-10
FLAT_IMPROVEMENT, FLAT_COST_RTOL = 1e-12, 1e-14
# the contact path (bench.py cartpole_limits)
B_CONTACT, B_CONTACT_PATH = 2048, 256
CONTACT_SEED = 1
NARROW_LOWER, NARROW_UPPER = (-0.6, -0.5), (0.6, 0.5)
MIN_ACTIVE_SHARE = 0.05
CG_CHECK = (None, 4, 1)
NEAR_IMPULSE, NEAR_LIMIT = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "float64": 34e12}  # non-tensor-core FP32 / FP64


def log(*args) -> None:
    print(*args, flush=True)


def elapsed() -> str:
    return f"[{time.perf_counter() - T_START:7.1f} s]"


KERNELS = {"riccati_backward": riccati_backward, "linearize": linearize,
           "rollout_gains": rollout_gains}
PLAIN = {"riccati_backward": riccati_backward_plain, "linearize": linearize_plain,
         "rollout_gains": rollout_gains_plain}
# every kernel wrapper, with its launch counter
WRAPPERS = {"riccati_backward": riccati_backward, "linearize": linearize,
            "rollout_gains": rollout_gains, "linearize_split": linearize_split,
            "rollout_classes": rollout_classes}
EXPECTED_LAUNCHES = {"riccati_backward": ITERS, "linearize": ITERS,
                     "rollout_gains": ITERS + 1, "linearize_split": 0, "rollout_classes": 0}
EXPECTED_CONTACT = {"riccati_backward": ITERS, "linearize": 0,
                    "rollout_gains": ITERS + 1, "linearize_split": ITERS, "rollout_classes": 1}
# the contact path's kernels: K6, K4 and K2 on frozen classes
CONTACT_KERNELS = {"rollout_classes": rollout_classes, "linearize_split": linearize_split,
                   "rollout_gains[classes]": rollout_gains}
CONTACT_PLAIN = {"rollout_classes": rollout_classes_plain,
                 "linearize_split": linearize_split_plain,
                 "rollout_gains[classes]": rollout_gains_plain}
CONTACT_COUNTER = {"rollout_classes": "rollout_classes", "linearize_split": "linearize_split",
                   "rollout_gains[classes]": "rollout_gains"}
REPLACES = {
    "riccati_backward": ("nimblephysics_tpu_torch/csrc/riccati.cu",
                         "nimblephysics_tpu/ops/pallas_riccati.py:329"),
    "linearize": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                  "nimblephysics_tpu/ops/pallas_linearize.py:205"),
    "rollout_gains": ("nimblephysics_tpu_torch/csrc/rollout.cu",
                      "nimblephysics_tpu/ops/pallas_rollout.py:371"),
    "linearize_split": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                        "nimblephysics_tpu/ops/pallas_linearize.py:335"),
    "rollout_classes": ("nimblephysics_tpu_torch/csrc/rollout.cu",
                        "nimblephysics_tpu/ops/pallas_rollout.py:213"),
    "rollout_gains[classes]": ("nimblephysics_tpu_torch/csrc/rollout.cu",
                               "nimblephysics_tpu/ops/pallas_rollout.py:371"),
}


def model_for(dev, dtype):
    return relax_limits(builders.cartpole(dt=0.02, dtype=dtype, device=dev))


def costs_for(model):
    """bench.py's cartpole costs: 0.1 sum q^2 + 1e-3 sum u^2 and 10 sum x^2."""
    return QuadraticCost(model, wq=0.1, wu=1e-3), QuadraticFinalCost(model, wx=10.0)


def kernel_inputs(dev, B, T, dtype):
    """Each kernel's arguments as the main path gives them: x0 and u from
    numpy with a fixed seed, then the open-loop rollout, the cost
    derivatives and the Riccati gains from the plain versions."""
    rng = np.random.default_rng(SEED)
    x0 = torch.tensor(rng.uniform(-0.3, 0.3, (B, 4)), dtype=dtype, device=dev)
    u = torch.tensor(0.5 * rng.standard_normal((B, T, 1)), dtype=dtype, device=dev)
    model = model_for(dev, dtype)
    rc, fc = costs_for(model)
    xs = rollout_gains_plain(model, rc, fc, x0, u.new_zeros(B, T + 1, 4), u,
                             u.new_zeros(B, T, 1, 4), u.new_zeros(B, T, 1),
                             u.new_ones(1))[0][0].contiguous()
    fx, fu = linearize_plain(model, xs[:, :-1].contiguous(), u)
    ric = (fx.contiguous(), fu.contiguous()) + _cost_derivatives(rc, fc, xs, u) + (
        torch.full((B,), 1e-3, dtype=dtype, device=dev),)
    K, k, _, _ = riccati_backward_plain(*ric)
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)
    return {
        "riccati_backward": ric,
        "linearize": (model, xs[:, :-1].contiguous(), u),
        "rollout_gains": (model, rc, fc, x0, xs, u, K.contiguous(), k.contiguous(), alphas),
    }


def riccati_inputs(dev, dtype, nx=6, na=3, T=9, B=B_CHECK):
    """Random well-posed backward-pass inputs for the second Riccati
    instance, (nx, na) = (6, 3), built as tests/test_torch_riccati.py
    builds them."""
    rng = np.random.default_rng(SEED)
    eye_x, eye_u = np.eye(nx), np.eye(na)
    G = rng.standard_normal((B, T, nx, nx))
    Ga = rng.standard_normal((B, T, na, na))
    Gx = rng.standard_normal((B, nx, nx))
    arrays = (
        0.1 * rng.standard_normal((B, T, nx, nx)) + eye_x,
        0.3 * rng.standard_normal((B, T, nx, na)),
        rng.standard_normal((B, T, nx)),
        rng.standard_normal((B, T, na)),
        np.einsum("btij,btkj->btik", G, G) / nx + 0.1 * eye_x,
        np.einsum("btij,btkj->btik", Ga, Ga) / na + 0.5 * eye_u,
        0.1 * rng.standard_normal((B, T, na, nx)),
        rng.standard_normal((B, nx)),
        np.einsum("bij,bkj->bik", Gx, Gx) / nx + 0.1 * eye_x,
        np.abs(rng.standard_normal(B)) * 0.1 + 1e-3,
    )
    return tuple(torch.tensor(a, dtype=dtype, device=dev) for a in arrays)


def rel_errors(outs_k, outs_p):
    """(max abs err, max abs err / max |plain|) over pairs of kernel and
    plain outputs; every kernel output must be finite."""
    abs_err, rel_err = 0.0, 0.0
    for a, b in zip(outs_k, outs_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite kernel output")
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(float(b.abs().max()), 1e-30))
    return abs_err, rel_err


def compare(name, args):
    """rel_errors of the wrapper's outputs against the plain version's; the
    ok flags must agree exactly."""
    out_k = KERNELS[name](*args)
    sync()
    out_p = PLAIN[name](*args)
    pairs = [(a, b) for a, b in zip(out_k, out_p) if a.dtype != torch.bool]
    for a, b in zip(out_k, out_p):
        if a.dtype == torch.bool and not torch.equal(a, b):
            raise AssertionError(f"{name}: ok flags differ in {int((a != b).sum())} worlds")
    return rel_errors(*zip(*pairs))


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(fn, reps):
    """Mean time of one call on the card, from CUDA events around reps calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def riccati_step_ops(n: int, m: int) -> int:
    """Operations of one backward step of csrc/riccati.cu for one world,
    nx = n, na = m, term by term as the kernel does them."""
    return (2 * n * n + 2 * n ** 3 + 2 * n * n * m + 2 * n * m  # Qx, W = Vxx fx, Vxx fu, Qu
            + 2 * n ** 3 + n * n                               # Qxx
            + m * m * (4 * n + 3) + m * n * (4 * n + 3)        # Quu, Qux and their Tassa reg
            + m * (1 + 2 * m + 4 * m * (m - 1))                # Gauss-Jordan on [Quu_reg | I]
            + (m + m * n) * (2 * m + 1)                        # k, K
            + 2 * m * m + 5 * n * m + 2 * n * m * m            # Quu k, Vx, K^T Quu
            + 4 * n * n * m + n * n + 4 * n * n                # Vxx and its symmetrisation
            + 4 * m + 3)                                       # dV


def least_work(model, B, T, A, itemsize):
    """(bytes, operations) each kernel's function needs at these sizes:
    every input read once and every output written once; the arithmetic
    the kernel's note describes, with the model's constants left out. The
    device step's count is device_step.step_ops (csrc/step.cuh)."""
    nx, na = 2 * model.nq, model.num_actions
    step, tangent = device_step.step_ops(model)
    n, m = nx, na
    ric_in = B * T * (2 * n * n + n * m + n + m + m * m + m * n) + B * (n + n * n + 1)
    ric_out = B * T * (m * n + m) + 2 * B
    lin_io = B * T * (nx + na + nx * nx + nx * na)
    roll_in = B * nx + B * (T + 1) * nx + B * T * (na + na * nx + na) + A
    roll_out = A * B * ((T + 1) * nx + T * na + 1)
    return {
        # K1: one backward step per (world, t)
        "riccati_backward": (itemsize * (ric_in + ric_out) + B,
                             B * T * riccati_step_ops(n, m)),
        # K3: one plain step and nx + na tangents per point
        "linearize": (itemsize * lin_io, B * T * (step + (nx + na) * tangent)),
        # K2: per (alpha, world, t) the control law, the running cost and a
        # step; the final cost per (alpha, world)
        "rollout_gains": (itemsize * (roll_in + roll_out),
                          A * B * (T * (4 * nx + 2 * na * nx + 6 * na + 3 + step) + 3 * nx + 1)),
    }


def contact_least_work(model, B, T, A, itemsize):
    """(bytes, operations) of the contact path's kernels at these sizes, as
    least_work: every input read once, every output written once, and the
    kernel's arithmetic in closed form (ops/device_step.py: class_step_ops
    for K6; frozen_step_ops, a plain frozen step and nx + na tangents, for
    K4; the control law, the running cost and a plain frozen step per
    (alpha, world, t) for K2), all at the PCG depth m + 6."""
    nx, na, m = 2 * model.nq, model.num_actions, lcp_dim(model)
    frozen, tangent = device_step.frozen_step_ops(model, m + 6)
    cls = device_step.class_step_ops(model)
    n = B * T
    roll_in = B * nx + B * (T + 1) * nx + B * T * (na + na * nx + na) + A + 2 * n * m
    roll_out = A * B * ((T + 1) * nx + T * na + 1)
    return {
        # K6: x0 and u in; xs, cmask and us out; one class_step per (world, t)
        "rollout_classes": (itemsize * (B * nx + n * na + n * (nx + 2 * m)), n * cls),
        # K4: (xs, u, cmask, us) in, (fx, fu) out
        "linearize_split": (itemsize * n * (nx + na + 2 * m + nx * nx + nx * na),
                            n * (frozen + (nx + na) * tangent)),
        "rollout_gains[classes]": (itemsize * (roll_in + roll_out),
                                   A * B * (T * (4 * nx + 2 * na * nx + 6 * na + 3 + frozen)
                                            + 3 * nx + 1)),
    }


def solve(dev, dtype, use_kernels, x0_np, T):
    """One ilqr_solve_batch on bench.py's cartpole task; returns (solution,
    initial cost per world, seconds on the host clock)."""
    B, nx, na = x0_np.shape[0], 4, 1
    model = model_for(dev, dtype)
    rc, fc = costs_for(model)
    x0 = torch.tensor(x0_np, dtype=dtype, device=dev)
    u0 = torch.zeros((B, T, na), dtype=dtype, device=dev)
    cfg = ILQRConfig(iters=ITERS, alphas=ALPHAS, kernels=use_kernels)
    sync()
    t0 = time.perf_counter()
    sol = ilqr_solve_batch(model, x0, u0, rc, fc, cfg)
    sync()
    seconds = time.perf_counter() - t0
    cost0 = rollout_gains_plain(model, rc, fc, x0, u0.new_zeros(B, T + 1, nx), u0,
                                u0.new_zeros(B, T, na, nx), u0.new_zeros(B, T, na),
                                u0.new_ones(1))[2][0]
    return sol, cost0, seconds


def profile_solve(label, run):
    """One warm solve (``run()``) under torch.profiler: the device's busy
    time (the union of its kernel and copy intervals; CPU op rows, which
    repeat their kernels' time, are left out) against the host clock, and
    the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity in the solve")
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    log(f"  profiled {label}: wall {wall * 1e3:.2f} ms (profiler on), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.2f}%) over {len(spans)} device "
        f"events (kernel rows add up to {sum(r[0] for r in rows) / 1e3:.3f} ms); "
        "top device kernels:")
    for t_us, count, key in rows[:8]:
        log(f"    {t_us / 1e3:9.3f} ms  {count:5d} calls  {key[:90]}")


def check_solution(sol, cost0, label):
    if not (bool(torch.isfinite(sol.cost).all()) and bool(torch.isfinite(sol.u).all())):
        raise AssertionError(f"{label}: non-finite solution")
    worse = int((sol.cost > cost0).sum())
    if worse:
        raise AssertionError(f"{label}: final cost above the initial cost in {worse} worlds")
    log(f"  {label}: mean cost {float(cost0.mean()):.6f} -> {float(sol.cost.mean()):.6f}, "
        "all finite, none above its initial cost")


def reset_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def check_counts(label, expected):
    counts = {n: fn.launches for n, fn in WRAPPERS.items()}
    log(f"  launches ({label}): {counts}, expected {expected}")
    if counts != expected or min(c for n, c in counts.items() if expected[n]) == 0:
        raise AssertionError(f"{label}: launch counts {counts}")
    return counts


def last_accepted_improvement(sol):
    """Per world, the relative cost improvement of the last iteration whose
    step the solve accepted (inf where no iteration after the first was)."""
    hist = sol.cost_history                                        # (iters, B)
    impr = (hist[:-1] - hist[1:]) / hist[:-1].abs()
    it = torch.arange(impr.shape[0], device=impr.device)[:, None]
    last = torch.where(impr > 0, it, -1).amax(0)
    val = impr.gather(0, last.clamp(min=0)[None])[0]
    return torch.where(last >= 0, val, torch.full_like(val, float("inf")))


def u_agreement(label, sol_k, sol_p, rerun_plain, B, flat_end=False):
    """Hold the f64 kernel path's u to the plain path's. Near convergence
    two alphas of the line search can give costs within an ulp of each
    other, or a step can improve the cost by an ulp; which step is taken is
    then decided by rounding, and u moves by about alpha |k| between any two
    roundings of the same solve. The kernel path's costs differ from the
    plain path's by ~rel 1e-13, so where a world's u differs by more than
    U_TOL_F64 the plain path is run again from x0 moved by +-X0_SHIFT, which
    moves its costs by about as much. A world passes when its u differs by
    at most U_TOL_F64, or by at most U_SENS_FACTOR times the plain path's
    own move there. With ``flat_end`` a world also passes when both paths'
    last accepted step improved its cost by less than FLAT_IMPROVEMENT
    (a step that rounding decides) and their final costs agree to
    FLAT_COST_RTOL there. No excuse rests on the kernel path's own reruns."""
    dev = sol_k.u.device
    du_w = (sol_k.u - sol_p.u).abs().amax(dim=(1, 2))
    within = du_w <= U_TOL_F64
    sens_p = torch.zeros(B, dtype=torch.float64, device=dev)
    if not bool(within.all()):
        for shift in (X0_SHIFT, -X0_SHIFT):
            sens_p = torch.maximum(sens_p, (rerun_plain(shift).u - sol_p.u).abs().amax(dim=(1, 2)))
    by_move = ~within & (sens_p >= U_TOL_F64) & (du_w <= U_SENS_FACTOR * sens_p)
    by_flat = torch.zeros_like(within)
    if flat_end:
        lai_k, lai_p = last_accepted_improvement(sol_k), last_accepted_improvement(sol_p)
        dcost = (sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()
        by_flat = (~within & ~by_move & (lai_k < FLAT_IMPROVEMENT) & (lai_p < FLAT_IMPROVEMENT)
                   & (dcost <= FLAT_COST_RTOL))
    bad = ~(within | by_move | by_flat)
    log(f"  {label}: |u_kernel - u_plain| <= {U_TOL_F64:.0e} in {int(within.sum())} of {B} "
        f"worlds (max there {float(du_w.where(within, 0.0).max()):.3e}); the plain path from "
        f"x0 +-{X0_SHIFT:.0e} moves u by >= {U_TOL_F64:.0e} in "
        f"{int((sens_p >= U_TOL_F64).sum())} worlds")
    log(f"  {label}: excused by the plain path's own move (|du| <= {U_SENS_FACTOR:g} x it): "
        f"{int(by_move.sum())} worlds {by_move.nonzero().flatten().tolist()[:12]}")
    if flat_end:
        log(f"  {label}: excused by a rounding-level end (both paths' last accepted "
            f"improvement < rel {FLAT_IMPROVEMENT:.0e}, costs within rel "
            f"{FLAT_COST_RTOL:.0e}): {int(by_flat.sum())} worlds "
            f"{by_flat.nonzero().flatten().tolist()[:12]}, |du| "
            f"{['%.3e' % v for v in du_w[by_flat].tolist()[:12]]}, cost rel diff max "
            f"{float(dcost[by_flat].max()) if bool(by_flat.any()) else 0.0:.3e}")
    log(f"  {label}: {int(bad.sum())} worlds out of tolerance")
    if bool(bad.any()):
        worst = bad.nonzero().flatten()[:10].tolist()
        detail = "" if not flat_end else (
            f", last accepted improvement kernel {lai_k[worst].tolist()}, plain "
            f"{lai_p[worst].tolist()}, cost rel diff {dcost[worst].tolist()}")
        raise AssertionError(f"{label}: kernel path and plain path disagree on u in worlds "
                             f"{worst}: |du| {du_w[worst].tolist()}, the plain path's own "
                             f"move {sens_p[worst].tolist()}{detail}")


# ---------------------------------------------------------------- contact path


def contact_model(dev, dtype, narrow):
    """bench.py's cartpole_limits model: the stock cartpole with its limits,
    or with the narrowed limits of tests/test_frozen_contact.py."""
    model = builders.cartpole(dt=0.02, dtype=dtype, device=dev)
    if narrow:
        model = model.replace(q_lower=torch.tensor(NARROW_LOWER, dtype=dtype, device=dev),
                              q_upper=torch.tensor(NARROW_UPPER, dtype=dtype, device=dev))
    return model


def contact_x0(B, narrow):
    """bench.py's cartpole_limits start states, numpy uniform(-0.3, 0.3) with
    seed 1, on the stock model (whose limits they rarely reach); on the
    narrowed model the cart within +-0.55 m and the pole within +-0.45 rad,
    both moving at up to 2 units/s, so that the limits are hit."""
    rng = np.random.default_rng(CONTACT_SEED)
    if not narrow:
        return rng.uniform(-0.3, 0.3, (B, 4))
    return np.concatenate([rng.uniform(-0.55, 0.55, (B, 1)), rng.uniform(-0.45, 0.45, (B, 1)),
                           rng.uniform(-2.0, 2.0, (B, 2))], axis=1)


def contact_kernel_inputs(dev, B, T, dtype):
    """K6, K4 and K2-with-classes arguments on the narrowed model: x0 as the
    contact path's, u from numpy (std 5) with a fixed seed; K6's plain
    version gives the trajectory and its classes, K4's plain version, the
    cost derivatives and the Riccati plain version give the gains."""
    model = contact_model(dev, dtype, True)
    rc, fc = costs_for(model)
    x0 = torch.tensor(contact_x0(B, True), dtype=dtype, device=dev)
    u = torch.tensor(5.0 * np.random.default_rng(SEED).standard_normal((B, T, 1)),
                     dtype=dtype, device=dev)
    xs_post, cl = rollout_classes_plain(model, x0, u)
    xs = torch.cat([x0[:, None], xs_post], dim=1).contiguous()
    classes = (cl.cmask.contiguous(), cl.us.contiguous())
    pre = xs[:, :-1].contiguous()
    fx, fu = linearize_split_plain(model, pre, u, classes)
    ric = (fx.contiguous(), fu.contiguous()) + _cost_derivatives(rc, fc, xs, u) + (
        torch.full((B,), 1e-3, dtype=dtype, device=dev),)
    K, k, _, _ = riccati_backward_plain(*ric)
    alphas = torch.tensor(ALPHAS, dtype=dtype, device=dev)
    return {
        "rollout_classes": ((model, x0, u), {}),
        "linearize_split": ((model, pre, u, classes), {}),
        "rollout_gains[classes]": ((model, rc, fc, x0, xs, u, K.contiguous(), k.contiguous(),
                                    alphas), {"classes": classes}),
    }


def impulses_near(model, x, u):
    """Per point, whether the full step's LCP (the lane solve K6 runs) has
    an active row (one whose class its impulse decides) with an impulse
    within NEAR_IMPULSE of CLAMPING_THRESHOLD, or a limited q within
    NEAR_LIMIT of its limit (where the row's activation flips): where
    rounding may decide a class."""
    nq = model.nq
    q, v = x[:, :nq], x[:, nq:]
    kin = dyn.forward_kinematics(model, q)
    v_star = v + model.dt * dyn.aba(model, q, v, model.action_to_tau(u), kin=kin)
    _, A, b, lo, hi, _, _ = build_constraint_system(
        model, q, v_star, kin, detect_contacts(model, kin.T_wb), planner=False, spd_solve=True)
    imp = direct_boxed_solve_lane(A, b, lo, hi)
    Ld = list(limited_dofs(model))
    qL = q[:, Ld]
    near_q = ((qL - model.q_lower[Ld]).abs() <= NEAR_LIMIT) | ((qL - model.q_upper[Ld]).abs() <= NEAR_LIMIT)
    active = hi > 0.5 * _BIG
    near_imp = ((imp - CLAMPING_THRESHOLD).abs() <= NEAR_IMPULSE) & active
    return near_imp.any(-1) | near_q.any(-1)


def compare_contact(name, args, kwargs, dname):
    """(max abs err, rel err) of a contact kernel against its plain version.
    For K6 also the class masks: identical in f64; in f32 each world's first
    differing step must be a near-threshold point (impulses_near), and the
    world's later steps leave the comparison."""
    out_k = CONTACT_KERNELS[name](*args, **kwargs)
    sync()
    out_p = CONTACT_PLAIN[name](*args, **kwargs)
    if name != "rollout_classes":
        return rel_errors(out_k, out_p)
    model, x0, u = args
    (xk, ck), (xp, cp) = out_k, out_p
    diff = (ck.cmask != cp.cmask).any(-1)                           # (B, T)
    worlds = diff.any(-1)
    n_w = int(worlds.sum())
    if n_w:
        if dname == "float64":
            raise AssertionError(f"rollout_classes f64: classes differ in {n_w} worlds")
        wi = worlds.nonzero().flatten()
        first = diff[wi].int().argmax(-1)
        near = torch.zeros(n_w, dtype=torch.bool, device=x0.device)
        for xs in (xp, xk):
            pre = torch.where((first == 0)[:, None], x0[wi],
                              xs[wi, (first - 1).clamp(min=0)])
            near |= impulses_near(model, pre, u[wi, first])
        far = int((~near).sum())
        log(f"  rollout_classes {dname}: classes differ in {n_w} worlds, each first at a point "
            f"near a class boundary in {n_w - far} (impulse within {NEAR_IMPULSE:.0e} of "
            f"{CLAMPING_THRESHOLD:.0e} or q within {NEAR_LIMIT:.0e} of a limit), elsewhere in {far}")
        if far:
            raise AssertionError(f"rollout_classes {dname}: classes differ away from a class boundary")
    else:
        log(f"  rollout_classes {dname}: classes identical in all {x0.shape[0]} worlds "
            f"({float(cp.cmask.amax(-1).mean()):.4f} of the points with a clamping row)")
    keep = ~worlds
    return rel_errors([xk[keep]], [xp[keep]])


def contact_solve(dev, dtype, use_kernels, x0_np, narrow, T=H):
    """One solve_contact_mpc_batch on bench.py's cartpole_limits task;
    returns (solution, returned classes, seconds on the host clock)."""
    model = contact_model(dev, dtype, narrow)
    rc, fc = costs_for(model)
    x0 = torch.tensor(x0_np, dtype=dtype, device=dev)
    u0 = torch.zeros((x0.shape[0], T, 1), dtype=dtype, device=dev)
    cfg = ILQRConfig(iters=ITERS, alphas=ALPHAS, kernels=use_kernels)
    sync()
    t0 = time.perf_counter()
    sol, classes = solve_contact_mpc_batch(model, x0, u0, rc, fc, cfg, outer_iters=1)
    sync()
    return sol, classes, time.perf_counter() - t0


def contact_cost0(dev, dtype, x0_np, narrow, T=H):
    """Each world's cost before the solve: u0 = 0 rolled on the frozen-class
    step under the classes of its own full-LCP rollout (plain versions)."""
    model = contact_model(dev, dtype, narrow)
    rc, fc = costs_for(model)
    x0 = torch.tensor(x0_np, dtype=dtype, device=dev)
    B, nx = x0.shape
    u0 = torch.zeros((B, T, 1), dtype=dtype, device=dev)
    _, cl = rollout_classes_plain(model, x0, u0)
    return rollout_gains_plain(model, rc, fc, x0, u0.new_zeros(B, T + 1, nx), u0,
                               u0.new_zeros(B, T, 1, nx), u0.new_zeros(B, T, 1),
                               u0.new_ones(1), classes=(cl.cmask, cl.us))[2][0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr, flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    log(f"{elapsed()} phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")

    log(f"{elapsed()} phase 2: build")
    path, nvcc_s = _build.build()
    _build.load()
    log(f"build: one nvcc call, {nvcc_s:.1f} s "
        f"({'built now' if nvcc_s else 'already built'}) -> {path}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    log(f"{elapsed()} phase 3: each kernel against its plain version, B={B_CHECK}, T={H}")
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        inputs = kernel_inputs(dev, B_CHECK, H, dtype)
        for name in KERNELS:
            abs_err, rel_err = compare(name, inputs[name])
            ok = rel_err <= TOL[dname]
            log(f"  {name:17s} {dname}: max abs err {abs_err:.3e}, rel err {rel_err:.3e} "
                f"(tol rel {TOL[dname]:.0e}) {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {dname} disagrees with its plain version")
        abs_err, rel_err = compare("riccati_backward", riccati_inputs(dev, dtype))
        ok = rel_err <= TOL[dname]
        log(f"  riccati_backward  {dname}, (nx, na) = (6, 3), T=9: max abs err {abs_err:.3e}, "
            f"rel err {rel_err:.3e} (tol rel {TOL[dname]:.0e}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"riccati_backward (6, 3) {dname} disagrees with its plain version")

    log(f"{elapsed()} phase 3b: each kernel at the main path's shapes, f32, B={B_FULL}, T={H}")
    full = kernel_inputs(dev, B_FULL, H, torch.float32)
    records = {}
    for name in KERNELS:
        args = full[name]
        abs_err, rel_err = compare(name, args)
        if rel_err > TOL["float32"]:
            raise AssertionError(f"{name}: f32 disagrees at the main path's shapes")
        ms = time_ms(lambda: KERNELS[name](*args), 20)
        plain_ms = time_ms(lambda: PLAIN[name](*args), 2)
        records[name] = (abs_err, ms, plain_ms)
        log(f"  {name:17s} max abs err {abs_err:.3e} (rel {rel_err:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    work = least_work(full["linearize"][0], B_FULL, H, len(ALPHAS), 4)

    log(f"{elapsed()} phase 4: ilqr_solve_batch at full width, B={B_FULL}, H={H}, "
        f"iters={ITERS}, alphas={ALPHAS}")
    x0_np = np.random.default_rng(SEED).uniform(-0.3, 0.3, (B_FULL, 4))
    reset_counts()
    sol_k, cost0_64, s_k = solve(dev, torch.float64, True, x0_np, H)
    check_counts("f64 kernel path", EXPECTED_LAUNCHES)
    sol_p, _, s_p = solve(dev, torch.float64, False, x0_np, H)
    dc = float(((sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()).max())
    log(f"  f64: kernel path {s_k:.3f} s, plain path {s_p:.3f} s; max rel cost diff {dc:.3e} "
        f"(tol {COST_RTOL_F64:.0e})")
    u_agreement("f64 contact-free", sol_k, sol_p,
                lambda shift: solve(dev, torch.float64, False, x0_np + shift, H)[0], B_FULL)
    if not dc <= COST_RTOL_F64:
        raise AssertionError("f64 kernel path and plain path disagree on the cost")
    check_solution(sol_k, cost0_64, "f64 kernel path")

    reset_counts()
    sol32, cost0_32, s_first = solve(dev, torch.float32, True, x0_np, H)
    counts = check_counts("f32 contact-free path", EXPECTED_LAUNCHES)
    check_solution(sol32, cost0_32, "f32 kernel path")
    times = [solve(dev, torch.float32, True, x0_np, H)[2] for _ in range(3)]
    rate = B_FULL / (sum(times) / len(times))
    log(f"  f32 kernel path: first {s_first:.4f} s, warm {[round(t, 4) for t in times]} s "
        f"-> {rate:.1f} solves/s (B={B_FULL}, H={H})")

    model32 = model_for(dev, torch.float32)
    rc32, fc32 = costs_for(model32)
    x0_32 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    u0_32 = torch.zeros((B_FULL, H, 1), dtype=torch.float32, device=dev)
    profile_solve("f32 contact-free solve", lambda: ilqr_solve_batch(
        model32, x0_32, u0_32, rc32, fc32, ILQRConfig(iters=ITERS, alphas=ALPHAS)))
    derivs_ms = time_ms(lambda: _cost_derivatives(*full["rollout_gains"][1:3],
                                                  full["rollout_gains"][4],
                                                  full["rollout_gains"][5]), 5)
    log(f"  cost derivatives (torch.func, B={B_FULL}, T={H}, f32): {derivs_ms:.3f} ms per call")

    log(f"{elapsed()} phase 5: the contact kernels against their plain versions, narrowed "
        f"limits, B={B_CHECK}, T={H}")
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        inputs = contact_kernel_inputs(dev, B_CHECK, H, dtype)
        for name in CONTACT_KERNELS:
            args, kwargs = inputs[name]
            for cg in (CG_CHECK if name == "linearize_split" else (None,)):
                kw = dict(kwargs, cg_iters=cg) if cg is not None else kwargs
                abs_err, rel_err = compare_contact(name, args, kw, dname)
                ok = rel_err <= TOL[dname]
                tag = f"{name}{'' if cg is None else f' cg_iters={cg}'}"
                log(f"  {tag:28s} {dname}: max abs err {abs_err:.3e}, rel err {rel_err:.3e} "
                    f"(tol rel {TOL[dname]:.0e}) {'PASS' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{tag} {dname} disagrees with its plain version")

    log(f"{elapsed()} phase 5b: the contact kernels at the contact path's shapes, f32, "
        f"B={B_CONTACT}, T={H}")
    full_c = contact_kernel_inputs(dev, B_CONTACT, H, torch.float32)
    for name in CONTACT_KERNELS:
        args, kwargs = full_c[name]
        abs_err, rel_err = compare_contact(name, args, kwargs, "float32")
        if rel_err > TOL["float32"]:
            raise AssertionError(f"{name}: f32 disagrees at the contact path's shapes")
        ms = time_ms(lambda: CONTACT_KERNELS[name](*args, **kwargs), 20)
        plain_ms = time_ms(lambda: CONTACT_PLAIN[name](*args, **kwargs), 2)
        records[name] = (abs_err, ms, plain_ms)
        log(f"  {name:22s} max abs err {abs_err:.3e} (rel {rel_err:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    work.update(contact_least_work(full_c["rollout_classes"][0][0], B_CONTACT, H,
                                   len(ALPHAS), 4))

    log(f"{elapsed()} phase 6: solve_contact_mpc_batch in f64, kernel path against plain "
        f"path, narrowed limits, B={B_CONTACT_PATH}, H={H}")
    x0_c = contact_x0(B_CONTACT_PATH, True)
    reset_counts()
    sol_k, cl_k, s_k = contact_solve(dev, torch.float64, True, x0_c, True)
    check_counts("f64 contact kernel path", EXPECTED_CONTACT)
    sol_p, cl_p, s_p = contact_solve(dev, torch.float64, False, x0_c, True)
    dc = float(((sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()).max())
    log(f"  f64: kernel path {s_k:.3f} s, plain path {s_p:.3f} s; max rel cost diff {dc:.3e} "
        f"(tol {COST_RTOL_F64:.0e}); returned classes differ at "
        f"{int((cl_k.cmask != cl_p.cmask).any(-1).sum())} of {cl_p.cmask[..., 0].numel()} points")
    # the contact solve takes rounding-level steps (rel 1e-15 improvements)
    # in most worlds near its end
    u_agreement("f64 contact", sol_k, sol_p,
                lambda shift: contact_solve(dev, torch.float64, False, x0_c + shift, True)[0],
                B_CONTACT_PATH, flat_end=True)
    if not dc <= COST_RTOL_F64:
        raise AssertionError("f64 contact kernel path and plain path disagree on the cost")
    check_solution(sol_k, contact_cost0(dev, torch.float64, x0_c, True), "f64 contact kernel path")

    log(f"{elapsed()} phase 7: solve_contact_mpc_batch at full width, f32, B={B_CONTACT}, "
        f"H={H}, iters={ITERS}, alphas={ALPHAS}")
    contact_rates = {}
    for narrow in (False, True):
        label = f"f32 contact path, {'narrowed' if narrow else 'stock'} limits"
        x0_np_c = contact_x0(B_CONTACT, narrow)
        cost0 = contact_cost0(dev, torch.float32, x0_np_c, narrow)
        reset_counts()
        sol_c, cl_c, s_first = contact_solve(dev, torch.float32, True, x0_np_c, narrow)
        counts_c = check_counts(label, EXPECTED_CONTACT)
        check_solution(sol_c, cost0, label)
        share = float(cl_c.cmask.amax(-1).mean())
        times = [contact_solve(dev, torch.float32, True, x0_np_c, narrow)[2] for _ in range(3)]
        contact_rates[narrow] = B_CONTACT / (sum(times) / len(times))
        log(f"  {label}: first {s_first:.4f} s, warm {[round(t, 4) for t in times]} s -> "
            f"{contact_rates[narrow]:.1f} solves/s, replan {1e3 * sum(times) / len(times):.2f} "
            f"ms; {share:.4f} of the (world, step) points have a clamping row")
        if narrow and share < MIN_ACTIVE_SHARE:
            raise AssertionError(f"{label}: only {share:.4f} of the points have a clamping "
                                 f"row (at least {MIN_ACTIVE_SHARE} asked)")
    model_c = contact_model(dev, torch.float32, True)
    rc_c, fc_c = costs_for(model_c)
    x0_cc = torch.tensor(contact_x0(B_CONTACT, True), dtype=torch.float32, device=dev)
    u0_cc = torch.zeros((B_CONTACT, H, 1), dtype=torch.float32, device=dev)
    profile_solve("f32 contact replan (narrowed limits)", lambda: solve_contact_mpc_batch(
        model_c, x0_cc, u0_cc, rc_c, fc_c, ILQRConfig(iters=ITERS, alphas=ALPHAS),
        outer_iters=1))

    out = []
    for name in list(KERNELS) + list(CONTACT_KERNELS):
        b, ops = work[name]
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        abs_err, ms, plain_ms = records[name]
        launches = (counts[name] if name in KERNELS
                    else counts_c[CONTACT_COUNTER[name]])
        out.append({
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1], "launches": launches,
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"  {name}: least bytes {b} ({t_bytes:.5f} ms), operations {ops} "
            f"({t_ops:.5f} ms)")
    log(f"{elapsed()} done: contact-free {rate:.1f} solves/s (B={B_FULL}); contact "
        f"{contact_rates[False]:.1f} (stock limits) and {contact_rates[True]:.1f} (narrowed) "
        f"solves/s (B={B_CONTACT}); nvcc {nvcc_s:.1f} s")
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
