#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nimblephysics_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's three paths on the card, after building the CUDA kernels
and holding each one against its plain PyTorch version:

  * the contact-free batched iLQR replan of ``bench.py``'s cartpole row
    (B=4096 worlds, H=100, 8 iterations, 6 alphas): kernels K1 (Riccati),
    K3 (linearize) and K2 (line-search rollout);
  * the joint-limit contact MPC replan of ``bench.py``'s cartpole_limits
    row, ``solve_contact_mpc_batch(class_refresh="rollout")`` (B=2048,
    H=100, 8 iterations, 6 alphas): kernels K6 (full-LCP class rollout),
    K4 (linearize of the frozen-class step), K2 on frozen classes and K1,
    on the stock cartpole (limits +-1 m, +-1.57 rad) and on a cartpole
    with narrowed limits (+-0.6 m, +-0.5 rad) started into them;
  * the jump worm's frictional-contact MPC replan of ``bench.py``'s
    jump_worm_contact_b2048 row, ``solve_contact_mpc_batch(class_refresh=
    "pointwise")`` (B=2048, H=100, 4 iterations, 4 alphas, PCG depth 12):
    kernels K7 (batched PGS inside the classification), K5 (row-VJP
    linearize), K2 on frozen classes with contact rows and K1; the same
    replan with ``ILQRConfig(linearize="jvp")``, whose linearize is K3's
    classes= form (K4's kernel at PCG depth m + 6), and with
    ``linearize="split"``, K4's kernel at the replan's PCG depth, and with
    ``linearize="chain"``, whose linearize is K8 (``ops/lane_chain.py``
    ``chained_linearize_vjp``, K5's kernel); and K9 (``ops/lane_chain.py``
    ``chained_step_rollout``, K2's kernel at one alpha with zero gains) at
    the worm's full width;
  * the serving edge: ``realtime/mpc.py`` ``MPC`` (every replan one
    ``ilqr_solve_batch`` call at B=1: K3, K1 and K2) closing the loop on the
    cartpole, and ``AsyncMPC`` publishing through the native seqlock buffer
    (``native/``, built with g++ in phase 2).

Phases:

  1. environment: torch, the card, its power limit (nvidia-smi);
  2. build: one nvcc per source, all at once, then a link (skipped when
     already built),
     its time and ptxas's registers and spills; then the native serving
     library (g++);
  3. K1-K3 against their plain versions at B=512, T=100, in f64
     (rel 1e-9) and f32 (rel 2e-4), and the Riccati kernel's second
     instance, (nx, na) = (6, 3), then the Riccati kernel's lane-group
     layout at its three instances; then each kernel at the contact-free
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
  8. the worm path's kernels, K7 (batched PGS), K5 (row-VJP linearize), K2
     with classes at m = 28 and K1 at (nx, na) = (8, 2), against their
     plain versions on the worm's own inputs (bench.py's x0, u from numpy,
     the plain pointwise refresh's states and classes) at B=512, T=100:
     f64 rel 1e-9, f32 rel 2e-4 (K7's classes identical in f64, differing
     in f32 only near CLAMPING_THRESHOLD or the cone bound; a row beyond
     tolerance also passes where the plain version's own move under a
     +-1e-13 input shift is at least the tolerance and at most 1e-6 and
     the kernel differs by at most twice that move, for at most 0.2% of
     the rows (at least 4), counts printed); then K2 over one step and K5
     on 256 sliding worm points whose friction rows ride the cone, at PCG
     depths 1 and 2, with no row excused (f64 rel 1e-9, f32 rel 2e-4);
     then each kernel at B=2048 in f32 with kernel and plain times. It
     first prints the lane-group layouts of K2's, K4's and K5's worm
     instances and of K7 (lanes per group, groups per block, shared bytes
     per block), and the layouts of K2's (without and with classes) and
     K4's cartpole instances (one thread per pair or point, threads and
     shared bytes per block);
  9. the worm replan in f64, kernel path against plain path, B=256, from
     cold (two pointwise refreshes): costs rel 1e-10, u as in phase 6,
     no world above its initial cost;
 10. the worm replan at full width in f32 (B=2048, H=100, 4 iterations, 4
     alphas, PCG 12): cold (launch counts K2 7, K7 3, K5 4, K1 4), then
     warm replans threading u and the classes (K2 5, K7 1, K5 4, K1 4: the
     JAX package refreshes only when classes is None), no world above its
     initial cost, the share of points with a clamping contact row (> 0),
     three timed warm replans and one profiled;
 11. K3 with classes= (K4's kernel at PCG depth m + 6) against its plain
     version (linearize_split_plain at m + 6) on the narrowed cartpole at
     B=512 (f64 rel 1e-9, f32 rel 2e-4); the worm's K4 instance on the 256
     sliding points at PCG depths 1 and 2 with no row excused; a model
     without a kernel instance raises in each new wrapper; K3 with
     classes= on the worm's inputs (phase 8's rules) in f64 at B=64 and
     in f32 at B=2048, timed there; then the worm replan with
     linearize="jvp" in f32 at B=2048, warm from phase 10's cold replan,
     with launch counts (K3 4, K5 0), then three warm replans timed as in
     phase 10; then K4 at the replan's PCG depth 12 on the worm's inputs
     the same way (f64 at B=64, f32 at B=2048, timed) and the worm replan
     with linearize="split" (K4 4, K5 0) as with "jvp";
 12. K8 on the 256 sliding points at PCG depths 1 and 2, no row excused;
     K9 against its plain version in f64 at B=512 on the worm's inputs with
     some controls 40 times larger (beyond the +-100 limits), phase 8's
     rules; K9's own path, one call at B=2048 in f32 (launch count 1),
     then K9 and K8 there in f32, timed; the worm replan with
     linearize="chain": f64 at B=256 from cold, kernel path against phase
     9's plain path (the plain path of "chain" runs the same functions)
     under phase 9's rules (K8 4, K5 0), then f32 as "jvp" in phase 11;
 13. the serving edge (realtime/mpc.py, realtime/buffer.py, the native
     buffer) in f32: tests/test_realtime.py's closed loop on the stock
     cartpole (the plant keeps its limits, the planner is relax_limits of
     it), 120 plant steps with a replan every 5, each replan launching K3
     and K1 once per iteration and K2 once more, at that test's MPCConfig
     (horizon 40, 6 warm and 30 cold iterations) with the pole within its
     bounds, then at MPCConfig's defaults (horizon 100, 8 warm and 40
     cold), where the relaxed planner lets the pole fall in the JAX
     package too, so the pole is printed, not held; cold and warm replan
     ms; the first warm replan at the defaults in f64 against the same
     ilqr_solve_batch call under kernels=False (phase 6's rules for cost
     and u); AsyncMPC at the defaults on the simulated clock for the same
     120 steps: at least 2 plans published through the native buffer,
     control_now's median latency below 20 ms, control_now_native finite;
 14. a JSON line with every kernel's numbers and its layout ("design"),
     then the result line.

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

from nimblephysics_tpu_torch import native
from nimblephysics_tpu_torch.models import builders
from nimblephysics_tpu_torch.models.model import State, relax_limits
from nimblephysics_tpu_torch.ops import _build, device_step
from nimblephysics_tpu_torch.ops import dynamics as dyn
from nimblephysics_tpu_torch.ops.collide import detect_contacts
from nimblephysics_tpu_torch.ops.contact import (
    build_constraint_system,
    lcp_dim,
    lcp_findex,
    limited_dofs,
)
from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched, pgs_batched_plain
from nimblephysics_tpu_torch.ops.cuda_linearize import (
    linearize,
    linearize_plain,
    linearize_split,
    linearize_split_plain,
    linearize_vjp,
    linearize_vjp_plain,
)
from nimblephysics_tpu_torch.ops.frozen_contact import classify_points
from nimblephysics_tpu_torch.ops.lane_chain import (
    chained_linearize_vjp,
    chained_linearize_vjp_plain,
    chained_step_rollout,
    chained_step_rollout_plain,
)
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward, riccati_backward_plain
from nimblephysics_tpu_torch.ops.cuda_rollout import (
    rollout_classes,
    rollout_classes_plain,
    rollout_gains,
    rollout_gains_plain,
)
from nimblephysics_tpu_torch.ops.lcp import (
    _BIG,
    CLAMPING_THRESHOLD,
    _classify,
    direct_boxed_solve_lane,
    lcp_residual,
)
from nimblephysics_tpu_torch.realtime import MPC, AsyncMPC, MPCConfig
from nimblephysics_tpu_torch.simulation.step import step
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
# A worm kernel's row beyond tolerance is excused (worm_rows_within) only
# where the plain version's own move stays at or below EXCUSE_MOVE_MAX, and
# for at most EXCUSE_SHARE_MAX of the rows (at least EXCUSE_ROWS_MIN).
EXCUSE_MOVE_MAX = 1e-6
EXCUSE_SHARE_MAX = 2e-3
EXCUSE_ROWS_MIN = 4
COST_RTOL_F64 = 1e-10
FLAT_IMPROVEMENT, FLAT_COST_RTOL = 1e-12, 1e-14
# the contact path (bench.py cartpole_limits)
B_CONTACT, B_CONTACT_PATH = 2048, 256
CONTACT_SEED = 1
NARROW_LOWER, NARROW_UPPER = (-0.6, -0.5), (0.6, 0.5)
MIN_ACTIVE_SHARE = 0.05
CG_CHECK = (None, 4, 1)
NEAR_IMPULSE, NEAR_LIMIT = 1e-4, 1e-5
# the worm path (bench.py jump_worm_contact_b2048)
WORM_B, WORM_B_CHECK, WORM_B_PATH = 2048, 512, 256
WORM_ITERS, WORM_ALPHAS, WORM_CG, WORM_SEED = 4, (1.0, 0.6, 0.3, 0.1), 12, 1
WORM_LCP_ITERS = 60
WORM_M = 28  # the worm's LCP rows: 8 contact slots of 3 rows and 4 limit rows
# sliding worm points whose friction rows ride the cone, and the PCG depths
# at which K2 and K5 are held to their plain versions there with no excuse
WORM_COUPLED_B, COUPLED_CG = 256, (1, 2)
# K3 with classes= in f64 on the worm's own inputs (phase 11)
WORM_B_SLICE = 64
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
            "rollout_classes": rollout_classes, "linearize_vjp": linearize_vjp,
            "pgs_batched": pgs_batched, "chained_linearize_vjp": chained_linearize_vjp,
            "chained_step_rollout": chained_step_rollout}
_NONE = {name: 0 for name in WRAPPERS}
EXPECTED_LAUNCHES = dict(_NONE, riccati_backward=ITERS, linearize=ITERS,
                         rollout_gains=ITERS + 1)
EXPECTED_CONTACT = dict(_NONE, riccati_backward=ITERS, rollout_gains=ITERS + 1,
                        linearize_split=ITERS, rollout_classes=1)
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
    "linearize": ("nimblephysics_tpu_torch/csrc/linearize_free.cu",
                  "nimblephysics_tpu/ops/pallas_linearize.py:205"),
    "rollout_gains": ("nimblephysics_tpu_torch/csrc/rollout.cu",
                      "nimblephysics_tpu/ops/pallas_rollout.py:371"),
    "linearize_split": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                        "nimblephysics_tpu/ops/pallas_linearize.py:335"),
    "rollout_classes": ("nimblephysics_tpu_torch/csrc/classes.cu",
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
    device step's count is device_step.step_ops (csrc/step.cuh); K3's is
    device_step.k3_least_ops, the step once and each direction's tangent
    alone, with what the direction leaves fixed plain."""
    nx, na = 2 * model.nq, model.num_actions
    step, _ = device_step.step_ops(model)
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
        # K3: per point one plain step and each direction's tangent alone
        "linearize": (itemsize * lin_io, B * T * device_step.k3_least_ops(model)),
        # K2: per (alpha, world, t) the control law, the running cost (its
        # target subtracted) and a step; the final cost per (alpha, world)
        "rollout_gains": (itemsize * (roll_in + roll_out),
                          A * B * (T * (5 * nx + 2 * na * nx + 6 * na + 3 + step) + 4 * nx + 1)),
    }


def contact_least_work(model, B, T, A, itemsize):
    """(bytes, operations) of the contact path's kernels at these sizes, as
    least_work: every input read once, every output written once, and the
    kernel's arithmetic in closed form (ops/device_step.py: class_step_ops
    for K6; for K4 the smaller of frozen_step_ops' count, a plain frozen
    step and nx + na forward-mode tangents of it, and the factored form's,
    jvp_point_least_ops, the tangents through the factors of A; the
    control law, the running cost and a plain frozen step per (alpha,
    world, t) for K2), all at the PCG depth m + 6."""
    nx, na, m = 2 * model.nq, model.num_actions, lcp_dim(model)
    frozen, tangent = device_step.frozen_step_ops(model, m + 6)
    k4_point = min(frozen + (nx + na) * tangent, device_step.jvp_point_least_ops(model, m + 6))
    cls = device_step.class_step_ops(model)
    n = B * T
    roll_in = B * nx + B * (T + 1) * nx + B * T * (na + na * nx + na) + A + 2 * n * m
    roll_out = A * B * ((T + 1) * nx + T * na + 1)
    return {
        # K6 (csrc/classes.cu): x0 and u in; xs, cmask and us out; one
        # class_step per (world, t)
        "rollout_classes": (itemsize * (B * nx + n * na + n * (nx + 2 * m)), n * cls),
        # K4: (xs, u, cmask, us) in, (fx, fu) out
        "linearize_split": (itemsize * n * (nx + na + 2 * m + nx * nx + nx * na), n * k4_point),
        "rollout_gains[classes]": (itemsize * (roll_in + roll_out),
                                   A * B * (T * (5 * nx + 2 * na * nx + 6 * na + 3 + frozen)
                                            + 4 * nx + 1)),
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


def kernel_launches():
    """The port's kernel launches so far, by the wrappers' counters (one
    kernel per wrapper launch)."""
    return sum(fn.launches for fn in WRAPPERS.values())


def profile_solve(label, run, attempts=2):
    """One warm solve (``run()``) under torch.profiler: the device's busy
    time (the union of its kernel and copy intervals; CPU op rows, which
    repeat their kernels' time, are left out) against the host clock, and
    the kernels with the most device time. The profiler can drop device
    events; where it saw fewer of the port's kernels than the wrappers
    launched, the solve is profiled again (``attempts`` in all), and a
    profile still short says so: its busy share undercounts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        launched = kernel_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = kernel_launches() - launched
        averages = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
        seen = sum(ev.count for ev in averages if "nptt::" in ev.key)
        if seen == launched:
            break
        log(f"  profiled {label}: the profiler saw {seen} of the port's {launched} kernel "
            f"launches (attempt {attempt + 1} of {attempts})")
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity in the solve")
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key) for ev in averages),
                  reverse=True)
    short = "" if seen == launched else (f"; it lost {launched - seen} of the port's "
                                         f"{launched} kernel launches, so busy undercounts")
    log(f"  profiled {label}: wall {wall * 1e3:.2f} ms (profiler on), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.2f}%) over {len(spans)} device "
        f"events (kernel rows add up to {sum(r[0] for r in rows) / 1e3:.3f} ms; the port's "
        f"kernels {seen} of {launched} launches seen{short}); top device kernels:")
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


# ------------------------------------------------------------ the worm path


def worm_model(dev, dtype):
    """bench.py's jump_worm_contact_b2048 model: builders.jump_worm(dt=0.001)."""
    return builders.jump_worm(dt=0.001, dtype=dtype, device=dev)


def worm_costs(model):
    """bench.py's jump-worm task: running 1e-5 sum u^2 + 2 (q1 + 0.4)^2, final
    20 (q1 + 0.4)^2."""
    goal = torch.zeros(2 * model.nq, dtype=model.dtype, device=model.device)
    goal[1] = -0.4
    wq = torch.zeros(model.nq, dtype=model.dtype, device=model.device)
    wq[1] = 2.0
    wx = torch.zeros(2 * model.nq, dtype=model.dtype, device=model.device)
    wx[1] = 20.0
    return (QuadraticCost(model, wq=wq, wu=1e-5, x_goal=goal),
            QuadraticFinalCost(model, wx=wx, x_goal=goal))


def worm_x0(B):
    """bench.py's jump-worm start states: q = 0 with q1 = -0.5, plus 0.02 N(0, 1)
    on q from numpy's default_rng(WORM_SEED); v = 0."""
    q = np.zeros((B, 4))
    q[:, 1] = -0.5
    q = q + 0.02 * np.random.default_rng(WORM_SEED).standard_normal((B, 4))
    return np.concatenate([q, np.zeros_like(q)], axis=1)


def worm_config(use_kernels=True, lin="auto"):
    """bench.py's contact budget: 4 iterations, 4 alphas, PCG depth 12,
    linearize "auto" (K5 on the worm) unless ``lin`` says otherwise."""
    return ILQRConfig(iters=WORM_ITERS, alphas=WORM_ALPHAS, planner_cg_iters=WORM_CG,
                      kernels=use_kernels, linearize=lin)


def worm_lcps(model, pre, u):
    """The full LCPs that classify_points solves at the points (pre, u):
    (A, b, lo, hi, fscale, x0 = 0), each with the points' leading axes."""
    nq = model.nq
    q, v = pre[..., :nq], pre[..., nq:]
    kin = dyn.forward_kinematics(model, q)
    v_star = v + model.dt * dyn.aba(model, q, v, model.action_to_tau(u), kin=kin)
    _, A, b, lo, hi, fs, _ = build_constraint_system(
        model, q, v_star, kin, detect_contacts(model, kin.T_wb))
    return A, b, lo, hi, fs, torch.zeros_like(b)


def worm_kernel_inputs(dev, B, T, dtype):
    """The worm path's kernel arguments: x0 as the path's, u from numpy (std
    5, seed SEED); the states of the plain pointwise refresh (two rounds from
    no clamping row: the frozen rollout on the plain K2, then the plain
    classify_points) and the classes of its last classification; K5's plain
    version, the cost derivatives and the plain Riccati pass give the gains;
    K7 gets the classification's LCPs at those points."""
    model = worm_model(dev, dtype)
    rc, fc = worm_costs(model)
    x0 = torch.tensor(worm_x0(B), dtype=dtype, device=dev)
    u = torch.tensor(5.0 * np.random.default_rng(SEED).standard_normal((B, T, 2)),
                     dtype=dtype, device=dev)
    m, nx = lcp_dim(model), 2 * model.nq
    cm = us = torch.zeros((B, T, m), dtype=dtype, device=dev)
    for _ in range(2):
        xs = rollout_gains_plain(model, rc, fc, x0, u.new_zeros(B, T + 1, nx), u,
                                 u.new_zeros(B, T, 2, nx), u.new_zeros(B, T, 2), u.new_ones(1),
                                 classes=(cm, us), cg_iters=WORM_CG)[0][0].contiguous()
        cl, _ = classify_points(model, xs[:, :-1], model.action_to_tau(u), kernels=False)
        cm, us = cl.cmask.contiguous(), cl.us.contiguous()
    classes = (cm, us)
    pre = xs[:, :-1].contiguous()
    fx, fu = linearize_vjp_plain(model, pre, u, classes, WORM_CG)
    ric = (fx.contiguous(), fu.contiguous()) + _cost_derivatives(rc, fc, xs, u) + (
        torch.full((B,), 1e-3, dtype=dtype, device=dev),)
    K, k, _, _ = riccati_backward_plain(*ric)
    alphas = torch.tensor(WORM_ALPHAS, dtype=dtype, device=dev)
    lcps = tuple(t.reshape((B * T,) + t.shape[2:]).contiguous() for t in worm_lcps(model, pre, u))
    return {
        "pgs_batched": (lcps + (lcp_findex(model), WORM_LCP_ITERS), {}),
        "linearize_vjp": ((model, pre, u, classes, WORM_CG), {}),
        "rollout_gains[worm]": ((model, rc, fc, x0, xs, u, K.contiguous(), k.contiguous(),
                                 alphas), {"classes": classes, "cg_iters": WORM_CG}),
        "riccati_backward[worm]": (ric, {}),
    }


WORM_KERNELS = {"pgs_batched": pgs_batched, "linearize_vjp": linearize_vjp,
                "rollout_gains[worm]": rollout_gains,
                "riccati_backward[worm]": riccati_backward}
WORM_PLAIN = {"pgs_batched": pgs_batched_plain, "linearize_vjp": linearize_vjp_plain,
              "rollout_gains[worm]": rollout_gains_plain,
              "riccati_backward[worm]": riccati_backward_plain}
WORM_COUNTER = {"pgs_batched": "pgs_batched", "linearize_vjp": "linearize_vjp",
                "rollout_gains[worm]": "rollout_gains",
                "riccati_backward[worm]": "riccati_backward"}


def linearize_classes(model, xs, u, classes):
    """K3's classes= form (K4 at the PCG depth m + 6)."""
    return linearize(model, xs, u, classes=classes)


def linearize_classes_plain(model, xs, u, classes):
    return linearize_split_plain(model, xs, u, classes)


# the kernels phases 11 and 12 add: K3 with classes, K8 and K9, each held as
# the worm kernels are (compare_worm)
SLICE_KERNELS = {"linearize[classes]": linearize_classes,
                 "linearize_split[worm]": linearize_split,
                 "chained_linearize_vjp": chained_linearize_vjp,
                 "chained_step_rollout": chained_step_rollout}
SLICE_PLAIN = {"linearize[classes]": linearize_classes_plain,
               "linearize_split[worm]": linearize_split_plain,
               "chained_linearize_vjp": chained_linearize_vjp_plain,
               "chained_step_rollout": chained_step_rollout_plain}
SLICE_COUNTER = {"linearize[classes]": "linearize",
                 "linearize_split[worm]": "linearize_split",
                 "chained_linearize_vjp": "chained_linearize_vjp",
                 "chained_step_rollout": "chained_step_rollout"}
# every kernel compare_worm holds to its plain version
CHECKED = dict(WORM_KERNELS, **SLICE_KERNELS)
CHECKED_PLAIN = dict(WORM_PLAIN, **SLICE_PLAIN)
# per replan: warm classes skip the refresh (the JAX package's
# solve_contact_mpc_batch refreshes only when classes is None), so K2 runs
# the first rollout and one line search per iteration and K7 the final
# classification; a cold replan adds refresh_fixed_point = 2 refreshes,
# each one K2 rollout and one K7 classification
EXPECTED_WORM_WARM = dict(_NONE, riccati_backward=WORM_ITERS, rollout_gains=WORM_ITERS + 1,
                          linearize_vjp=WORM_ITERS, pgs_batched=1)
EXPECTED_WORM_COLD = dict(EXPECTED_WORM_WARM, rollout_gains=WORM_ITERS + 3, pgs_batched=3)
# linearize="jvp" takes K3's classes= form (K4 at depth m + 6), "split" K4
# at the replan's PCG depth, "chain" K8
EXPECTED_JVP_WARM = dict(EXPECTED_WORM_WARM, linearize_vjp=0, linearize=WORM_ITERS)
EXPECTED_SPLIT_WARM = dict(EXPECTED_WORM_WARM, linearize_vjp=0, linearize_split=WORM_ITERS)
EXPECTED_CHAIN_COLD = dict(EXPECTED_WORM_COLD, linearize_vjp=0,
                           chained_linearize_vjp=WORM_ITERS)
EXPECTED_CHAIN_WARM = dict(EXPECTED_WORM_WARM, linearize_vjp=0,
                           chained_linearize_vjp=WORM_ITERS)
REPLACES.update({
    "pgs_batched": ("nimblephysics_tpu_torch/csrc/lcp.cu",
                    "nimblephysics_tpu/ops/pallas_lcp.py:96"),
    "linearize_vjp": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                      "nimblephysics_tpu/ops/pallas_linearize.py:498"),
    "rollout_gains[worm]": ("nimblephysics_tpu_torch/csrc/rollout.cu",
                            "nimblephysics_tpu/ops/pallas_rollout.py:371"),
    "riccati_backward[worm]": ("nimblephysics_tpu_torch/csrc/riccati.cu",
                               "nimblephysics_tpu/ops/pallas_riccati.py:329"),
    "linearize[classes]": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                           "nimblephysics_tpu/ops/pallas_linearize.py:205"),
    "linearize_split[worm]": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                              "nimblephysics_tpu/ops/pallas_linearize.py:335"),
    "chained_linearize_vjp": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                              "nimblephysics_tpu/ops/lane_chain.py:738"),
    "chained_step_rollout": ("nimblephysics_tpu_torch/csrc/rollout.cu",
                             "nimblephysics_tpu/ops/lane_chain.py:1023"),
})


# each kernel's layout on the card, for the kernels' JSON line
_K2_GROUPS = ("lane groups (csrc/frozen_group.cuh): one group per {} with the frozen "
              "step's rows on its lanes and Qf in shared memory")
_K5_GROUPS = ("one fused kernel, a lane group per point (csrc/frozen_group.cuh): the primal "
              "and nq adjoint PCGs over one Qf in shared memory, the tangent through the "
              "factors of A, one lane per direction of (x, u)")
_K4_GROUPS = ("at m = 28 a lane group per point (csrc/frozen_group.cuh): the primal PCG, the "
              "tangent right-hand sides through the factors of A, one lane per direction of "
              "(x, u), then the nx + na tangent PCGs over one Qf in shared memory")
_K2_THREAD = ("one thread per (alpha, world), the alphas of a world on neighbouring lanes, "
              "32 threads per block (csrc/rollout.cu)")
_K1_GROUPS = ("a lane group per world (csrc/riccati.cu), a lane per row of Vxx; the inputs "
              "read in place, a chunk of steps ahead staged in shared memory by cp.async")
DESIGN = {
    "riccati_backward": _K1_GROUPS,
    "linearize": ("one thread per (point, direction), a block of neighbouring points per "
                  "direction (csrc/linearize_free.cu linearize_dir): a direction of q on dual "
                  "numbers throughout, one of v with the transforms and articulated inertias "
                  "plain, one of u with the velocities plain too; the step's loops under a plain "
                  "#pragma unroll"),
    "rollout_gains": _K2_THREAD,
    "linearize_split": ("one thread per point (csrc/linearize.cu linearize_point): each "
                        "direction's dual inputs, the primal once (its dynamics' values from the "
                        "first direction), each direction's tangent right-hand side through the "
                        "factors of A, then its tangent PCG over the point's one Qf; what passes "
                        "between the phases in shared memory"),
    "rollout_classes": ("one thread per world, 16 threads per block (csrc/classes.cu): the "
                        "packed model by value in the kernel's parameters, u read and (xs, "
                        "cmask) written in the wrapper's layouts, the next step's u loaded "
                        "ahead, the step's loops under a plain #pragma unroll"),
    "rollout_gains[classes]": _K2_THREAD + ", the frozen PCG dividing no zero (qdiv)",
    "pgs_batched": ("a lane group per LCP (csrc/lcp.cu): the rows on the lanes, each lane's "
                    "rows of A in registers, the residual kept current by one broadcast per "
                    "row update"),
    "linearize_vjp": _K5_GROUPS, "rollout_gains[worm]": _K2_GROUPS.format("(alpha, world)"),
    "riccati_backward[worm]": _K1_GROUPS,
    "linearize[classes]": "K4's kernel at PCG depth m + 6: " + _K4_GROUPS,
    "linearize_split[worm]": "K4's kernel at PCG depth 12: " + _K4_GROUPS,
    "chained_linearize_vjp": "K5's kernel: " + _K5_GROUPS,
    "chained_step_rollout": "K2's kernel at one alpha: " + _K2_GROUPS.format("world"),
}


def cartpole_layouts():
    """One line per cartpole instance of K2 (without and with classes) and
    K4: its layout as built (csrc/frozen_group.cuh k2_lanes and k4_lanes,
    csrc/rollout.cu kK2Threads), f32 and f64."""
    lines = []
    for name, m, what, unit in (("rollout", 0, "K2 without classes", "(alpha, world)"),
                                ("rollout", 4, "K2 with classes", "(alpha, world)"),
                                ("linearize_split", 4, "K4", "point")):
        lay = {d: _build.layout(name, m, dt) for d, dt in (("f32", torch.float32),
                                                           ("f64", torch.float64))}
        if lay["f32"]["lanes"]:
            how = (f"a lane group of {lay['f32']['lanes']} per {unit}, "
                   f"{lay['f32']['per_block']} groups per block")
        else:
            how = f"one thread per {unit}, {lay['f32']['per_block']} threads per block"
        lines.append(f"{what} on the cartpole (m = {m}): {how}, shared memory per block "
                     f"{lay['f32']['shared_bytes']} B (f32) / {lay['f64']['shared_bytes']} B (f64)")
    return lines


def worm_least_work(model, B, T, A, itemsize, n_lcp_iters=WORM_LCP_ITERS, cg=WORM_CG):
    """(bytes, operations) of the worm path's kernels, as least_work: every
    input read once, every output written once, and the kernel's
    arithmetic in closed form. K7: per LCP m divisions (the inverse
    diagonal), then per sweep and row a dot product of length m, the
    residual and the update, and on a friction row its coupled bound
    (pgs_solve's arithmetic; the sweep count is fixed, not data-dependent).
    K5: ops/device_step.py vjp_point_least_ops per point (the primal with
    its nq adjoint PCGs once, then nq reverse sweeps of the tangent through
    the factors of A at a tangent sweep's cost, not the kernel's 2 nq + na
    dual directions and its lanes' copies of the dynamics). K2 and K1 as
    contact_least_work and least_work, at the worm's shapes and PCG depth."""
    nx, na, m = 2 * model.nq, model.num_actions, lcp_dim(model)
    n = B * T
    nc = sum(1 for f in lcp_findex(model) if f >= 0)
    frozen, _ = device_step.frozen_step_ops(model, cg)
    roll_in = B * nx + B * (T + 1) * nx + B * T * (na + na * nx + na) + A + 2 * n * m
    roll_out = A * B * ((T + 1) * nx + T * na + 1)
    ric_in = n * (2 * nx * nx + nx * na + nx + na + na * na + na * nx) + B * (nx + nx * nx + 1)
    return {
        "pgs_batched": (itemsize * n * (m * m + 6 * m) + 4 * m,
                        n * (m + n_lcp_iters * (m * (2 * m + 2) + 2 * nc))),
        "linearize_vjp": (itemsize * n * (nx + na + 2 * m + nx * nx + nx * na),
                          n * device_step.vjp_point_least_ops(model, cg)),
        "rollout_gains[worm]": (itemsize * (roll_in + roll_out),
                                A * B * (T * (5 * nx + 2 * na * nx + 6 * na + 3 + frozen)
                                         + 4 * nx + 1)),
        "riccati_backward[worm]": (itemsize * (ric_in + n * (na * nx + na) + 2 * B) + B,
                                   n * riccati_step_ops(nx, na)),
    }


def slice_least_work(model, B, T, itemsize, cg=WORM_CG):
    """(bytes, operations) of phases 11 and 12's kernels at the worm's
    shapes, as worm_least_work. K3 with classes: K4's function at the PCG
    depth m + 6, K4 on the worm the same at the PCG depth cg: (xs, u, cm,
    us) read and (fx, fu) written once, ops/device_step.py
    jvp_point_least_ops per point (the primal once, then per direction of
    (x, u) the tangent sweep of its inputs, its right-hand side through the
    factors of A, its PCG and its column; frozen_step_ops' nx + na
    tangents of the whole frozen step, contact_least_work's count, form
    the dual A and Qf per direction). K8: K5's (its bound at PCG depth cg).
    K9: x0, u and the classes read, xs and the cost written once; per
    (world, t) one frozen step at depth cg and the running cost (the goal
    subtracted, squared, weighted and summed over x and u)."""
    nx, na, m = 2 * model.nq, model.num_actions, lcp_dim(model)
    n = B * T
    frozen_cg, _ = device_step.frozen_step_ops(model, cg)
    lin_bytes = itemsize * n * (nx + na + 2 * m + nx * nx + nx * na)
    return {
        "linearize[classes]": (lin_bytes, n * device_step.jvp_point_least_ops(model, m + 6)),
        "linearize_split[worm]": (lin_bytes, n * device_step.jvp_point_least_ops(model, cg)),
        "chained_linearize_vjp": (lin_bytes, n * device_step.vjp_point_least_ops(model, cg)),
        "chained_step_rollout": (itemsize * (B * nx + n * (na + 2 * m) + B * (T + 1) * nx + B),
                                 n * (frozen_cg + 4 * nx + 3 * na)),
    }


def worm_sliding_points(dev, dtype, n, seed=SEED):
    """(model, x, u, cmask, us) at n worm states 3 mm into the floor and
    moving down, the root sliding at up to 1.5 m/s, the links near their
    lower limits, under strong pushes (numpy, seed ``seed``), with the
    classes of the plain classify_points: friction rows ride the cone
    (UPPER, us != 0), so the frozen solve's friction coupling is live."""
    model = worm_model(dev, dtype)
    rng = np.random.default_rng(seed)
    q = 0.01 * rng.standard_normal((n, 4))
    q[:, 1] += -0.528
    q[:, 2:] = 0.5 * np.abs(q[:, 2:])
    v = 0.05 * rng.standard_normal((n, 4))
    v[:, 1] = -0.4
    v[:, 0] = rng.uniform(-1.5, 1.5, n)
    u = 20.0 * rng.standard_normal((n, 2))
    x = torch.tensor(np.concatenate([q, v], axis=1), dtype=dtype, device=dev)
    ut = torch.tensor(u, dtype=dtype, device=dev)
    cl, _ = classify_points(model, x, model.action_to_tau(ut), kernels=False)
    return model, x, ut, cl.cmask.contiguous(), cl.us.contiguous()


def check_coupled_rows(dev):
    """K2 over one step (alpha 1, zero gains) and K5 at sliding worm points
    (worm_sliding_points, WORM_COUPLED_B of them), at PCG depths
    COUPLED_CG, against their plain versions with no row excused: f64 rel
    1e-9, f32 rel 2e-4. Over one step and a short PCG the cone points'
    normal equations do not amplify rounding (at depth 12 two summation
    orders of one step part there by far more than 1e-9), so this holds the
    friction coupling's arithmetic outright."""
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        model, x, u, cm, us = worm_sliding_points(dev, dtype, WORM_COUPLED_B)
        n_upper = int((us != 0).sum())
        log(f"  coupled rows {dname}: {WORM_COUPLED_B} sliding points, {n_upper} UPPER rows, "
            f"{int(cm.sum())} clamping rows")
        if n_upper == 0:
            raise AssertionError("the sliding worm points have no UPPER row")
        rc, fc = worm_costs(model)
        B, nx = x.shape
        classes = (cm[:, None].contiguous(), us[:, None].contiguous())
        x1, u1 = x[:, None].contiguous(), u[:, None].contiguous()
        for cg in COUPLED_CG:
            calls = {
                "rollout_gains[worm]": (
                    (model, rc, fc, x, x.new_zeros(B, 2, nx), u1, x.new_zeros(B, 1, 2, nx),
                     x.new_zeros(B, 1, 2), x.new_ones(1)),
                    {"classes": classes, "cg_iters": cg}),
                "linearize_vjp": ((model, x1, u1, classes, cg), {}),
            }
            for name, (args, kwargs) in calls.items():
                abs_err, rel_err = compare_worm(name, args, kwargs, dname, excuse=False)
                ok = rel_err <= TOL[dname]
                log(f"  {name:24s} {dname}, one step, PCG depth {cg}: max abs err "
                    f"{abs_err:.3e}, rel err {rel_err:.3e} (tol rel {TOL[dname]:.0e}, no row "
                    f"excused) {'PASS' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {dname} disagrees on the coupled rows")


def worm_solve(dev, dtype, use_kernels, x0_np, classes=None, u0=None, lin="auto"):
    """One solve_contact_mpc_batch(class_refresh="pointwise") on bench.py's
    jump-worm task with ILQRConfig(linearize=lin); returns (solution,
    returned classes, host seconds)."""
    model = worm_model(dev, dtype)
    rc, fc = worm_costs(model)
    x0 = torch.tensor(x0_np, dtype=dtype, device=dev)
    if u0 is None:
        u0 = torch.zeros((x0.shape[0], H, 2), dtype=dtype, device=dev)
    sync()
    t0 = time.perf_counter()
    sol, cl = solve_contact_mpc_batch(model, x0, u0, rc, fc, worm_config(use_kernels, lin),
                                      outer_iters=1, classes=classes,
                                      class_refresh="pointwise")
    sync()
    return sol, cl, time.perf_counter() - t0


def worm_cost0(dev, dtype, x0_np, u0, classes=None):
    """Each world's cost before a replan of the kernel path: u0 rolled on
    the frozen-class step (K2) under the classes the replan's first inner
    solve takes: the given warm classes, or from cold the pointwise
    refresh's (K2 and K7), the same calls on the same inputs as the
    replan's own first rollout, so the same numbers."""
    model = worm_model(dev, dtype)
    rc, fc = worm_costs(model)
    x0 = torch.tensor(x0_np, dtype=dtype, device=dev)
    B, nx = x0.shape
    u0 = u0.contiguous()
    z = u0.new_zeros((B, H, lcp_dim(model)))
    cl = (z, z) if classes is None else (classes.cmask.contiguous(), classes.us.contiguous())

    def roll(c):
        return rollout_gains(model, rc, fc, x0, u0.new_zeros(B, H + 1, nx), u0,
                             u0.new_zeros(B, H, 2, nx), u0.new_zeros(B, H, 2),
                             u0.new_ones(1), classes=c, cg_iters=WORM_CG)

    for _ in range(2 if classes is None else 0):
        c, _ = classify_points(model, roll(cl)[0][0][:, :-1], model.action_to_tau(u0))
        cl = (c.cmask, c.us)
    return roll(cl)[2][0]


def lcp_class_near(x, fs, findex):
    """Per row, whether rounding may decide its class (ops/lcp.py
    _classify): the impulse within NEAR_IMPULSE of CLAMPING_THRESHOLD; on a
    friction row also its normal impulse so, or |x| within NEAR_IMPULSE of
    the cone bound's tolerance band (CLAMPING_THRESHOLD max(bound, 1))."""
    gather = torch.tensor([max(f, 0) for f in findex], device=x.device)
    coupled = torch.tensor([f >= 0 for f in findex], device=x.device)
    xn = x[..., gather]
    bound = fs * xn.clamp(min=0.0)
    band = CLAMPING_THRESHOLD * bound.clamp(min=1.0)
    near = (x - CLAMPING_THRESHOLD).abs() <= NEAR_IMPULSE
    near_f = (((xn - CLAMPING_THRESHOLD).abs() <= NEAR_IMPULSE)
              | (((x.abs() - bound).abs() - band).abs() <= NEAR_IMPULSE))
    return near | (coupled & near_f)


# The argument a rounding-level shift moves, per worm kernel: K7's b, the
# linearizes' states, K2's and K9's x0 (K1's inputs are no contact point's).
WORM_SHIFTED = {"pgs_batched": 1, "linearize_vjp": 1, "rollout_gains[worm]": 3,
                "linearize[classes]": 1, "linearize_split[worm]": 1, "chained_linearize_vjp": 1,
                "chained_step_rollout": 2}


def _row_errors(name, outs, plains):
    """Per row (an LCP, a point or an (alpha, world) pair: the leading axes
    of K7's, K5's and K2's outputs), the max over the outputs of the max abs
    difference over that output's max |plain|."""
    lead = 1 if name in ("pgs_batched", "chained_step_rollout") else 2
    err = None
    for a, b in zip(outs, plains):
        scale = max(float(b.abs().max()), 1e-30)
        d = (a - b).abs().reshape(a.shape[:lead] + (-1,)).amax(-1).reshape(-1) / scale
        err = d if err is None else torch.maximum(err, d)
    return err


def worm_rows_within(name, args, kwargs, out_k, out_p, tol, label):
    """Hold each row of a worm kernel's outputs to tol, rel to each plain
    output's max. Where the frozen solve's PCG is badly conditioned
    (friction rows riding the cone), any two summation orders part after a
    few iterations (ROADMAP queue C); a row beyond tol therefore also passes
    where the plain version itself, run again with the shifted argument
    moved by +-X0_SHIFT, moves by at least tol and the kernel differs by at
    most U_SENS_FACTOR times that move, a move of at most EXCUSE_MOVE_MAX
    (a larger one would excuse any error); more excused rows than
    EXCUSE_SHARE_MAX of them (at least EXCUSE_ROWS_MIN) fail. No row is
    excused by the kernel's own reruns. Returns the largest rel error of a
    row that is not excused."""
    err = _row_errors(name, out_k, out_p)
    within = err <= tol
    move = torch.zeros_like(err)
    i = WORM_SHIFTED[name]
    for shift in (X0_SHIFT, -X0_SHIFT):
        a = list(args)
        a[i] = (a[i] + shift).contiguous()
        o = CHECKED_PLAIN[name](*a, **kwargs)
        o = (o,) if isinstance(o, torch.Tensor) else o
        move = torch.maximum(move, _row_errors(name, o, out_p))
    excused = (~within & (move >= tol) & (move <= EXCUSE_MOVE_MAX)
               & (err <= U_SENS_FACTOR * move))
    bad = ~(within | excused)

    def top(t, mask, fn):
        return float(fn(t[mask])) if bool(mask.any()) else 0.0

    log(f"  {name} {label}: {int(within.sum())} of {err.numel()} rows within rel {tol:.0e} "
        f"(max there {top(err, within, torch.max):.3e}); {int(excused.sum())} excused by the "
        f"plain version's own move under a +-{X0_SHIFT:.0e} shift (rel diff max "
        f"{top(err, excused, torch.max):.3e}, own move there min "
        f"{top(move, excused, torch.min):.3e}) {excused.nonzero().flatten().tolist()[:12]}; "
        f"{int(bad.sum())} out of tolerance {bad.nonzero().flatten().tolist()[:12]}")
    most = max(EXCUSE_ROWS_MIN, int(EXCUSE_SHARE_MAX * err.numel()))
    if int(excused.sum()) > most:
        raise AssertionError(f"{name} {label}: {int(excused.sum())} rows excused, at most "
                             f"{most} allowed")
    return top(err, ~excused, torch.max)


def compare_worm(name, args, kwargs, label="", excuse=True):
    """(max abs err, rel err) of a worm kernel against its plain version,
    the rel err taken over the rows worm_rows_within does not excuse (none
    without ``excuse``); for K7 also the classes its impulses give (the
    count of differing rows is printed)."""
    out_k = CHECKED[name](*args, **kwargs)
    sync()
    out_p = CHECKED_PLAIN[name](*args, **kwargs)
    if isinstance(out_k, torch.Tensor):
        out_k, out_p = (out_k,), (out_p,)
    pairs = [(a, b) for a, b in zip(out_k, out_p) if a.dtype != torch.bool]
    for a, b in zip(out_k, out_p):
        if a.dtype == torch.bool and not torch.equal(a, b):
            raise AssertionError(f"{name}: ok flags differ in {int((a != b).sum())} worlds")
    if name == "pgs_batched":
        A, b, lo, hi, fs, _, findex, _ = args
        ck = _classify(out_k[0], lo, hi, fs, findex)
        cp = _classify(out_p[0], lo, hi, fs, findex)
        diff = (ck[0] != cp[0]) | (ck[1] != cp[1])
        near = lcp_class_near(out_k[0], fs, findex) | lcp_class_near(out_p[0], fs, findex)
        far = int((diff & ~near).sum())
        log(f"  pgs_batched {str(b.dtype).split('.')[-1]}: classes differ at {int(diff.sum())} "
            f"of {diff.numel()} rows ({far} of them with both impulses farther than "
            f"{NEAR_IMPULSE:.0e} from CLAMPING_THRESHOLD); residual max kernel "
            f"{float(lcp_residual(A, out_k[0], b, lo, hi, fs, findex).max()):.3e}, plain "
            f"{float(lcp_residual(A, out_p[0], b, lo, hi, fs, findex).max()):.3e}")
        if b.dtype == torch.float64 and int(diff.sum()):
            raise AssertionError("pgs_batched f64: classes differ")
        if far:
            raise AssertionError("pgs_batched: classes differ away from the threshold")
    abs_err, rel_err = rel_errors(*zip(*pairs))
    tol = TOL[str(out_p[0].dtype).split(".")[-1]]
    if excuse and rel_err > tol and name in WORM_SHIFTED:
        ks, ps = zip(*pairs)
        rel_err = worm_rows_within(name, args, kwargs, ks, ps, tol, label)
    return abs_err, rel_err


def check_no_instance(dev):
    """A model without a kernel instance raises on the card; no wrapper
    falls back to its plain version: a pendulum with a joint limit."""
    model = builders.pendulum(dtype=torch.float64, device=dev).replace(
        q_lower=torch.tensor([-0.5], dtype=torch.float64, device=dev),
        q_upper=torch.tensor([0.5], dtype=torch.float64, device=dev))
    m = lcp_dim(model)
    xs = torch.zeros((2, 3, 2), dtype=torch.float64, device=dev)
    u = torch.zeros((2, 3, 1), dtype=torch.float64, device=dev)
    cm = torch.ones((2, 3, m), dtype=torch.float64, device=dev)
    calls = {"linearize[classes]": lambda: linearize(model, xs, u, classes=(cm, cm * 0)),
             "chained_linearize_vjp": lambda: chained_linearize_vjp(model, xs, u, (cm, cm * 0)),
             "chained_step_rollout": lambda: chained_step_rollout(
                 model, lambda x, uu, t: (uu * uu).sum(-1), xs[:, 0].contiguous(), u,
                 (cm, cm * 0))}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "no kernel instance" not in str(e):
                raise
            log(f"  {name} on a {m}-row pendulum: raises ({e})")
            continue
        raise AssertionError(f"{name}: a model without a kernel instance did not raise")


def slice_f64_replan(dev, lin, expected_cold, label, plain):
    """The worm replan with ILQRConfig(linearize=lin) in f64 at
    B=WORM_B_PATH from cold, the kernel path against ``plain`` = (x0,
    solution) of the plain path (phase 9's where the plain path runs the
    same functions), under phase 9's rules."""
    x0_w, sol_p = plain
    reset_counts()
    sol_k, _, s_k = worm_solve(dev, torch.float64, True, x0_w, lin=lin)
    check_counts(f"f64 worm {label} kernel path (cold)", expected_cold)
    dc = float(((sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()).max())
    log(f"  f64 {label}: kernel path {s_k:.3f} s; max rel cost diff {dc:.3e} against the plain "
        f"path (tol {COST_RTOL_F64:.0e})")
    u_agreement(f"f64 worm {label}", sol_k, sol_p,
                lambda shift: worm_solve(dev, torch.float64, False, x0_w + shift, lin=lin)[0],
                WORM_B_PATH, flat_end=True)
    if not dc <= COST_RTOL_F64:
        raise AssertionError(f"f64 worm {label}: kernel path and plain path disagree on the cost")
    u0_w = torch.zeros((WORM_B_PATH, H, 2), dtype=torch.float64, device=dev)
    check_solution(sol_k, worm_cost0(dev, torch.float64, x0_w, u0_w), f"f64 worm {label}")


def slice_f32_replan(dev, lin, expected_warm, label, warm):
    """The worm replan with ILQRConfig(linearize=lin) at full width in f32,
    warm from ``warm`` = (u, classes) of phase 10's cold replan: launch
    counts and no world above its initial cost on the first call, then
    three warm calls timed as phase 10 times its own. Returns (the counts,
    solves/s)."""
    x0_wf = worm_x0(WORM_B)
    cost0 = worm_cost0(dev, torch.float32, x0_wf, warm[0], warm[1])
    reset_counts()
    sol, cl, s1 = worm_solve(dev, torch.float32, True, x0_wf, classes=warm[1], u0=warm[0],
                             lin=lin)
    counts = check_counts(f"f32 worm {label}, warm", expected_warm)
    check_solution(sol, cost0, f"f32 worm {label}, warm")
    times, warm = [], (sol.u, cl)
    for _ in range(3):
        sol_t, cl_t, s = worm_solve(dev, torch.float32, True, x0_wf, classes=warm[1],
                                    u0=warm[0], lin=lin)
        times.append(s)
        warm = (sol_t.u, cl_t)
    rate = WORM_B / (sum(times) / len(times))
    log(f"  f32 worm {label}: first warm {s1:.4f} s, warm {[round(t, 4) for t in times]} s "
        f"-> {rate:.1f} solves/s, replan {1e3 * sum(times) / len(times):.2f} ms (B={WORM_B})")
    return counts, rate


def check_slice_kernel(name, args, kwargs, dname, label, excuse=True):
    """compare_worm of a phase 11 or 12 kernel, which must pass TOL[dname];
    returns the max abs err."""
    abs_err, rel_err = compare_worm(name, args, kwargs, label, excuse=excuse)
    ok = rel_err <= TOL[dname]
    log(f"  {name:24s} {label}: max abs err {abs_err:.3e}, rel err {rel_err:.3e} (tol rel "
        f"{TOL[dname]:.0e}{'' if excuse else ', no row excused'}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    return abs_err


def phase_11_12(dev, records, work, warm, plain, full_w):
    """Phases 11 (K3 with classes=) and 12 (K8 and K9); adds their records
    and least work, returns (launches per name on its path, solves/s of the
    "jvp" and "chain" worm replans). ``warm``: (u, classes) of phase 10's
    cold replan; ``plain``: (x0, solution) of phase 9's plain path;
    ``full_w``: phase 8b's worm_kernel_inputs at B=WORM_B in f32."""
    counts = {}
    log(f"{elapsed()} phase 11: K3 with classes= (K4 at PCG depth m + 6) against its plain "
        f"version: narrowed cartpole B={B_CHECK}, T={H}; the worm's sliding points")
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        model, pre, u, classes = contact_kernel_inputs(dev, B_CHECK, H, dtype)[
            "linearize_split"][0]
        out_k = linearize_classes(model, pre, u, classes)
        sync()
        abs_err, rel_err = rel_errors(out_k, linearize_classes_plain(model, pre, u, classes))
        ok = rel_err <= TOL[dname]
        log(f"  linearize[classes] cartpole {dname}: max abs err {abs_err:.3e}, rel err "
            f"{rel_err:.3e} (tol rel {TOL[dname]:.0e}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"linearize[classes] {dname} disagrees with its plain version")
        # the worm's K4 instance at the cone points, PCG depths 1 and 2
        model, x, uw, cm, us = worm_sliding_points(dev, dtype, WORM_COUPLED_B)
        cl1 = (cm[:, None].contiguous(), us[:, None].contiguous())
        x1, u1 = x[:, None].contiguous(), uw[:, None].contiguous()
        for cg in COUPLED_CG:
            out_k = linearize_split(model, x1, u1, cl1, cg)
            sync()
            abs_err, rel_err = rel_errors(out_k, linearize_split_plain(model, x1, u1, cl1, cg))
            ok = rel_err <= TOL[dname]
            log(f"  linearize_split[worm] {dname}, sliding points, PCG depth {cg}: max abs err "
                f"{abs_err:.3e}, rel err {rel_err:.3e} (tol rel {TOL[dname]:.0e}, no row "
                f"excused) {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"linearize_split[worm] {dname} disagrees on the cone points")
    check_no_instance(dev)
    # K3 with classes= on the worm's own inputs at depth m + 6, and K4 at the
    # replan's depth, f64
    model, pre, u, classes, _ = worm_kernel_inputs(dev, WORM_B_SLICE, H, torch.float64)[
        "linearize_vjp"][0]
    check_slice_kernel("linearize[classes]", (model, pre, u, classes), {}, "float64",
                       f"float64, B={WORM_B_SLICE}")
    check_slice_kernel("linearize_split[worm]", (model, pre, u, classes, WORM_CG), {}, "float64",
                       f"float64, B={WORM_B_SLICE}, PCG depth {WORM_CG}")
    model, pre, u, classes, _ = full_w["linearize_vjp"][0]
    args = (model, pre, u, classes)
    abs_err = check_slice_kernel("linearize[classes]", args, {}, "float32",
                                 f"float32, B={WORM_B}")
    ms = time_ms(lambda: linearize_classes(*args), 3)
    plain_ms = time_ms(lambda: linearize_classes_plain(*args), 1)
    records["linearize[classes]"] = (abs_err, ms, plain_ms)
    log(f"  linearize[classes] worm, f32, B={WORM_B}, T={H}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    counts_jvp, rate_jvp = slice_f32_replan(dev, "jvp", EXPECTED_JVP_WARM, 'linearize="jvp"',
                                            warm)
    counts["linearize[classes]"] = counts_jvp["linearize"]
    # K4 at the replan's PCG depth, f32 at full width, and its replan
    args12 = (model, pre, u, classes, WORM_CG)
    abs_err = check_slice_kernel("linearize_split[worm]", args12, {}, "float32",
                                 f"float32, B={WORM_B}, PCG depth {WORM_CG}")
    ms = time_ms(lambda: linearize_split(*args12), 3)
    plain_ms = time_ms(lambda: linearize_split_plain(*args12), 1)
    records["linearize_split[worm]"] = (abs_err, ms, plain_ms)
    log(f"  linearize_split[worm] f32, B={WORM_B}, T={H}, PCG depth {WORM_CG}: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms")
    counts_split, rate_split = slice_f32_replan(dev, "split", EXPECTED_SPLIT_WARM,
                                                'linearize="split"', warm)
    counts["linearize_split[worm]"] = counts_split["linearize_split"]

    log(f"{elapsed()} phase 12: K8 (chained_linearize_vjp) and K9 (chained_step_rollout) "
        f"against their plain versions; the worm replan with linearize=\"chain\"")
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        model, x, uw, cm, us = worm_sliding_points(dev, dtype, WORM_COUPLED_B)
        cl1 = (cm[:, None].contiguous(), us[:, None].contiguous())
        x1, u1 = x[:, None].contiguous(), uw[:, None].contiguous()
        for cg in COUPLED_CG:
            check_slice_kernel("chained_linearize_vjp", (model, x1, u1, cl1),
                               {"cg_iters": cg}, dname,
                               f"{dname}, sliding points, PCG depth {cg}", excuse=False)
    # K9 in f64 at the worm's kernel inputs, some controls beyond the limits
    inputs = worm_kernel_inputs(dev, WORM_B_CHECK, H, torch.float64)
    model, pre, u, classes, _ = inputs["linearize_vjp"][0]
    x0 = pre[:, 0].contiguous()
    u_far = u.clone()
    u_far[:, ::7] *= 40.0
    n_far = int((u_far.abs() > model.tau_upper[list(model.actuated)]).sum())
    log(f"  K9 inputs: {n_far} of {u_far.numel()} controls beyond the torque limits")
    if not n_far:
        raise AssertionError("K9's check has no control beyond the limits")
    rc, _ = worm_costs(model)
    check_slice_kernel("chained_step_rollout", (model, rc, x0, u_far.contiguous(), classes),
                       {"cg_iters": WORM_CG}, "float64", f"float64, B={WORM_B_CHECK}")
    del inputs
    # K9's own path: one call at full width, f32
    model, pre, u, classes, _ = full_w["linearize_vjp"][0]
    rc, _ = worm_costs(model)
    args9 = (model, rc, pre[:, 0].contiguous(), u, classes)
    kw9 = {"cg_iters": WORM_CG}
    reset_counts()
    xs9, cost9 = chained_step_rollout(*args9, **kw9)
    sync()
    c9 = check_counts("chained_step_rollout path", dict(_NONE, chained_step_rollout=1))
    counts["chained_step_rollout"] = c9["chained_step_rollout"]
    if not (bool(torch.isfinite(xs9).all()) and bool(torch.isfinite(cost9).all())):
        raise AssertionError("chained_step_rollout: non-finite output at full width")
    abs_err = check_slice_kernel("chained_step_rollout", args9, kw9, "float32",
                                 f"float32, B={WORM_B}")
    ms = time_ms(lambda: chained_step_rollout(*args9, **kw9), 3)
    plain_ms = time_ms(lambda: chained_step_rollout_plain(*args9, **kw9), 1)
    records["chained_step_rollout"] = (abs_err, ms, plain_ms)
    log(f"  chained_step_rollout f32, B={WORM_B}, T={H}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    args8 = full_w["linearize_vjp"][0]
    abs_err = check_slice_kernel("chained_linearize_vjp", args8[:4], {"cg_iters": WORM_CG},
                                 "float32", f"float32, B={WORM_B}")
    ms = time_ms(lambda: chained_linearize_vjp(*args8[:4], cg_iters=WORM_CG), 3)
    plain_ms = time_ms(lambda: chained_linearize_vjp_plain(*args8[:4], WORM_CG), 1)
    records["chained_linearize_vjp"] = (abs_err, ms, plain_ms)
    log(f"  chained_linearize_vjp f32, B={WORM_B}, T={H}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    # the plain path of "chain" runs chained_linearize_vjp_plain, which is
    # linearize_vjp_plain: phase 9's plain path, the same functions
    slice_f64_replan(dev, "chain", EXPECTED_CHAIN_COLD, 'linearize="chain"', plain)
    counts_chain, rate_chain = slice_f32_replan(dev, "chain", EXPECTED_CHAIN_WARM,
                                                'linearize="chain"', warm)
    counts["chained_linearize_vjp"] = counts_chain["chained_linearize_vjp"]
    work.update(slice_least_work(worm_model(dev, torch.float32), WORM_B, H, 4))
    return counts, {"jvp": rate_jvp, "split": rate_split, "chain": rate_chain}


# ---------------------------------------------------------- the serving edge

# tests/test_realtime.py's closed loop: the stock cartpole as the plant,
# relax_limits of it as the planner, a replan every SERVE_EVERY plant steps;
# gated on the pole at that test's MPCConfig (SERVE_TEST_CONFIG). At
# MPCConfig's defaults (horizon 100) the relaxed planner drives the cart
# into its 1 m limit and the pole falls, in the JAX package's MPC as in the
# port's (PERF.md section 6, PR 11), so there the loop is timed and its
# launches counted, and the pole only printed.
SERVE_STEPS, SERVE_EVERY, SERVE_DT = 120, 5, 0.02
SERVE_Q0 = (0.0, 0.15)
SERVE_POLE_END, SERVE_POLE_MAX = 0.12, 0.6
SERVE_LATENCY_MAX_S = 0.02
SERVE_TEST_CONFIG = dict(horizon=40, replan_iters=6, first_solve_iters=30)


def serving_setup(dev, dtype):
    """(plant, planner, running cost, final cost, start state):
    tests/test_realtime.py's costs as QuadraticCost (wq (0.2, 1.0), wu
    1e-4) and QuadraticFinalCost (wx (10, 50, 1, 1))."""
    plant = builders.cartpole(dt=SERVE_DT, dtype=dtype, device=dev)
    planner = relax_limits(plant)
    run = QuadraticCost(planner, wq=(0.2, 1.0), wu=1e-4)
    fin = QuadraticFinalCost(planner, wx=(10.0, 50.0, 1.0, 1.0))
    state = State(q=torch.tensor(SERVE_Q0, dtype=dtype, device=dev),
                  v=torch.zeros(2, dtype=dtype, device=dev))
    return plant, planner, run, fin, state


def serving_replan(mpc, now, label):
    """mpc.replan_at(now), holding the replan's launches to the iterations it
    ran, as phase 4 counts them: K3 and K1 once per iteration, K2 once more
    (the first open-loop rollout); returns its seconds."""
    reset_counts()
    iters = mpc.config.replan_iters if mpc.plan is not None else mpc.config.first_solve_iters
    dur = mpc.replan_at(now)
    expected = dict(_NONE, riccati_backward=iters, linearize=iters, rollout_gains=iters + 1)
    counts = {n: fn.launches for n, fn in WRAPPERS.items()}
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts}, expected {expected}")
    return dur


def serving_loop(dev, cfg, label, smi):
    """The closed loop in f32 under ``cfg``: a cold replan at t = 0, then
    SERVE_STEPS plant steps served by control_now, a replan every
    SERVE_EVERY; returns (cold ms, mean warm ms, |pole| per step)."""
    plant, planner, run, fin, state = serving_setup(dev, torch.float32)
    mpc = MPC(plant, run, fin, cfg, planning_model=planner, device=dev)
    t = 0.0
    mpc.record_state(t, state)
    cold = serving_replan(mpc, t, f"{label}: cold replan")
    warm, poles = [], []
    for i in range(SERVE_STEPS):
        u = mpc.control_now(t, state)
        state = step(plant, state, u)
        t += SERVE_DT
        mpc.record_state(t, state)
        if i % SERVE_EVERY == 0:
            warm.append(serving_replan(mpc, t, f"{label}: warm replan {len(warm) + 1}"))
        poles.append(float(state.q[1]))
    poles = np.abs(np.asarray(poles))
    cold_ms, warm_ms = 1e3 * cold, 1e3 * sum(warm) / len(warm)
    log(f"  {label} (horizon {cfg.horizon}, {cfg.replan_iters} warm and "
        f"{cfg.first_solve_iters} cold iterations): {1 + len(warm)} replans, each launching "
        f"K3 and K1 once per iteration and K2 once more; replan (host clock, ending in a "
        f"synchronize) cold {cold_ms:.2f} ms, warm mean {warm_ms:.2f} ms (min "
        f"{1e3 * min(warm):.2f}, max {1e3 * max(warm):.2f}); |pole| max {poles.max():.4f}, over "
        f"the last 20 steps {poles[-20:].max():.4f}; {smi}")
    return cold_ms, warm_ms, poles


def phase_serving(dev, smi):
    """The serving edge on the card (realtime/mpc.py, realtime/buffer.py,
    the native buffer) in f32: tests/test_realtime.py's closed loop at its
    own MPCConfig, gated on the pole, and at MPCConfig's defaults (horizon
    100, 8 warm and 40 cold iterations), timed; the first warm replan at the
    defaults against the plain path in f64; AsyncMPC on the simulated clock.
    Returns (cold ms, mean warm ms) at the defaults and the median serving
    ms."""
    cfg = MPCConfig()
    log(f"{elapsed()} phase 13: the serving edge, MPC on the cartpole (the plant with its "
        f"limits, the planner relax_limits of it), f32, a replan every {SERVE_EVERY} of "
        f"{SERVE_STEPS} plant steps")
    _, _, poles = serving_loop(dev, MPCConfig(**SERVE_TEST_CONFIG), "test_realtime.py's loop",
                               smi)
    if not (poles.max() < SERVE_POLE_MAX and poles[-20:].max() < SERVE_POLE_END):
        raise AssertionError(f"the serving MPC did not balance the cartpole: |pole| max "
                             f"{poles.max():.4f} (limit {SERVE_POLE_MAX}), last 20 steps "
                             f"{poles[-20:].max():.4f} (limit {SERVE_POLE_END})")
    cold_ms, warm_ms, _ = serving_loop(dev, cfg, "MPCConfig's defaults", smi)

    # the first warm replan in f64 against the same call on the plain path
    plant, planner, run, fin, state = serving_setup(dev, torch.float64)
    mpc = MPC(plant, run, fin, cfg, planning_model=planner, device=dev)
    mpc.record_state(0.0, state)
    serving_replan(mpc, 0.0, "f64 cold replan")
    state = step(plant, state, mpc.control_now(0.0, state))
    mpc.record_state(SERVE_DT, state)
    seen, replan = [], mpc._replan

    def recording(x0, u_warm, iters):
        seen.append((x0, u_warm, iters))
        return replan(x0, u_warm, iters)

    mpc._replan = recording
    serving_replan(mpc, SERVE_DT, "f64 first warm replan")
    x0, u_warm, iters = seen[0]

    def solve_one(x0, use_kernels):
        return ilqr_solve_batch(planner, x0[None].contiguous(), u_warm[None].contiguous(), run,
                                fin, ILQRConfig(iters=iters, kernels=use_kernels))

    sol_k, sol_p = solve_one(x0, True), solve_one(x0, False)
    if not torch.equal(sol_k.u[0], mpc.plan.u):
        raise AssertionError("the MPC's f64 warm plan is not its replan's solution")
    dc = float(((sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()).max())
    dk = float((sol_k.K - sol_p.K).abs().max())
    log(f"  f64 first warm replan, kernel path against plain path: max rel cost diff {dc:.3e} "
        f"(tol {COST_RTOL_F64:.0e}), |u| diff {float((sol_k.u - sol_p.u).abs().max()):.3e}, "
        f"|K| diff {dk:.3e}")
    u_agreement("f64 first warm replan", sol_k, sol_p,
                lambda shift: solve_one(x0 + shift, False), 1, flat_end=True)
    if not dc <= COST_RTOL_F64:
        raise AssertionError("f64 warm replan: kernel path and plain path disagree on the cost")

    # AsyncMPC on the simulated clock: the replanner thread publishes through
    # the native seqlock buffer while this thread serves and steps the plant
    plant, planner, run, fin, state = serving_setup(dev, torch.float32)
    mpc = MPC(plant, run, fin, cfg, planning_model=planner, device=dev)
    clock = [0.0]
    amp = AsyncMPC(mpc, clock=lambda: clock[0])
    amp.record_state(0.0, state)
    lat, poles = [], []
    with amp:
        deadline = time.perf_counter() + 60.0
        while mpc.plan is None and time.perf_counter() < deadline:
            time.sleep(0.01)
        if mpc.plan is None:
            raise AssertionError("AsyncMPC: the replanner published no plan in 60 s")
        for _ in range(SERVE_STEPS):
            t0 = time.perf_counter()
            u = amp.control_now(clock[0], state)
            lat.append(time.perf_counter() - t0)
            state = step(plant, state, u)
            clock[0] += SERVE_DT
            amp.record_state(clock[0], state)
            poles.append(float(state.q[1]))
        n_pub = amp.num_published
    u_native = amp.control_now_native(clock[0])
    med_ms = 1e3 * float(np.median(lat))
    durs = amp.replan_durations
    log(f"  AsyncMPC: {n_pub} plans published through the native buffer over {SERVE_STEPS} "
        f"plant steps ({len(durs)} replans, mean {1e3 * sum(durs) / max(len(durs), 1):.2f} ms); "
        f"control_now median {med_ms:.4f} ms, max {1e3 * max(lat):.4f} ms (limit "
        f"{1e3 * SERVE_LATENCY_MAX_S:.0f} ms); control_now_native {u_native}; |pole| max "
        f"{float(np.abs(poles).max()):.4f}; {smi}")
    if n_pub < 2:
        raise AssertionError(f"AsyncMPC published {n_pub} plans (at least 2 asked)")
    if not med_ms < 1e3 * SERVE_LATENCY_MAX_S:
        raise AssertionError(f"AsyncMPC: median serving latency {med_ms:.3f} ms")
    if u_native is None or u_native.shape != (plant.num_actions,) or not np.isfinite(u_native).all():
        raise AssertionError(f"AsyncMPC: control_now_native gave {u_native}")
    return cold_ms, warm_ms, med_ms


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
    log(f"build: one nvcc per source at once and a link, {nvcc_s:.1f} s "
        f"({'built now' if nvcc_s else 'already built'}) -> {path}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())
    t0 = time.perf_counter()
    native_path = native.build()
    log(f"native serving library: {time.perf_counter() - t0:.1f} s -> {native_path}")

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

    for nx, na in ((4, 1), (6, 3), (8, 2)):
        lay = {d: _build.riccati_layout(nx, na, dt) for d, dt in (("f32", torch.float32),
                                                                  ("f64", torch.float64))}
        log(f"  riccati_backward ({nx}, {na}): {lay['f32']['lanes']} lanes per world, "
            f"{lay['f32']['per_block']} worlds per block ({lay['f64']['per_block']} in f64), "
            f"chunks of {lay['f32']['chunk']} steps, shared memory per block "
            f"{lay['f32']['shared_bytes']} B (f32) / {lay['f64']['shared_bytes']} B (f64)")
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

    log(f"{elapsed()} phase 8: the worm path's kernels against their plain versions, "
        f"jump worm, B={WORM_B_CHECK}, T={H}")
    for name, groups in (("rollout", f"A x B = {len(WORM_ALPHAS)} x {WORM_B}"),
                         ("linearize_vjp", f"B x T = {WORM_B} x {H}"),
                         ("linearize_split", f"B x T = {WORM_B} x {H}"),
                         ("pgs", f"LCP of the B x T = {WORM_B} x {H}")):
        shapes = {d: (_build.layout(name, WORM_M, dt) if name in ("rollout", "linearize_split")
                      else _build.group_shape(name, dt))
                  for d, dt in (("f32", torch.float32), ("f64", torch.float64))}
        log(f"  {name} worm instance on lane groups: one group per {groups} at the path's "
            f"shape, {shapes['f32']['lanes']} lanes per group, "
            f"{shapes['f32']['per_block']} groups per block, shared memory per block "
            f"{shapes['f32']['shared_bytes']} B (f32) / {shapes['f64']['shared_bytes']} B (f64)")
    for line in cartpole_layouts():
        log("  " + line)
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        inputs = worm_kernel_inputs(dev, WORM_B_CHECK, H, dtype)
        cl = inputs["linearize_vjp"][0][3]
        log(f"  inputs {dname}: {float((cl[0].amax(-1) > 0).float().mean()):.4f} of the points "
            f"with a clamping row, {float((cl[0][..., :24].amax(-1) > 0).float().mean()):.4f} "
            f"with a clamping contact row, {int((cl[1] != 0).sum())} UPPER rows")
        for name in WORM_KERNELS:
            args, kwargs = inputs[name]
            abs_err, rel_err = compare_worm(name, args, kwargs, dname)
            ok = rel_err <= TOL[dname]
            log(f"  {name:24s} {dname}: max abs err {abs_err:.3e}, rel err {rel_err:.3e} "
                f"(tol rel {TOL[dname]:.0e}) {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {dname} disagrees with its plain version")
        del inputs
    check_coupled_rows(dev)

    log(f"{elapsed()} phase 8b: the worm kernels at the worm path's shapes, f32, "
        f"B={WORM_B}, T={H}")
    full_w = worm_kernel_inputs(dev, WORM_B, H, torch.float32)
    for name in WORM_KERNELS:
        args, kwargs = full_w[name]
        abs_err, rel_err = compare_worm(name, args, kwargs, "float32")
        if rel_err > TOL["float32"]:
            raise AssertionError(f"{name}: f32 disagrees at the worm path's shapes")
        ms = time_ms(lambda: WORM_KERNELS[name](*args, **kwargs), 10)
        plain_ms = time_ms(lambda: WORM_PLAIN[name](*args, **kwargs), 1)
        records[name] = (abs_err, ms, plain_ms)
        log(f"  {name:24s} max abs err {abs_err:.3e} (rel {rel_err:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    work.update(worm_least_work(full_w["linearize_vjp"][0][0], WORM_B, H, len(WORM_ALPHAS), 4))

    log(f"{elapsed()} phase 9: the worm replan in f64, kernel path against plain path, "
        f"B={WORM_B_PATH}, H={H}, pointwise refresh from cold")
    x0_w = worm_x0(WORM_B_PATH)
    reset_counts()
    sol_k, cl_k, s_k = worm_solve(dev, torch.float64, True, x0_w)
    check_counts("f64 worm kernel path (cold)", EXPECTED_WORM_COLD)
    sol_p, cl_p, s_p = worm_solve(dev, torch.float64, False, x0_w)
    sol_p_w = sol_p
    dc = float(((sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()).max())
    log(f"  f64: kernel path {s_k:.3f} s, plain path {s_p:.3f} s; max rel cost diff {dc:.3e} "
        f"(tol {COST_RTOL_F64:.0e}); returned classes differ at "
        f"{int((cl_k.cmask != cl_p.cmask).any(-1).sum())} of {cl_p.cmask[..., 0].numel()} points")
    u_agreement("f64 worm", sol_k, sol_p,
                lambda shift: worm_solve(dev, torch.float64, False, x0_w + shift)[0],
                WORM_B_PATH, flat_end=True)
    if not dc <= COST_RTOL_F64:
        raise AssertionError("f64 worm kernel path and plain path disagree on the cost")
    u0_w = torch.zeros((WORM_B_PATH, H, 2), dtype=torch.float64, device=dev)
    check_solution(sol_k, worm_cost0(dev, torch.float64, x0_w, u0_w), "f64 worm kernel path")

    log(f"{elapsed()} phase 10: the worm replan at full width, f32, B={WORM_B}, H={H}, "
        f"iters={WORM_ITERS}, alphas={WORM_ALPHAS}, PCG {WORM_CG}, pointwise refresh")
    x0_wf = worm_x0(WORM_B)
    u0_wf = torch.zeros((WORM_B, H, 2), dtype=torch.float32, device=dev)
    cost0 = worm_cost0(dev, torch.float32, x0_wf, u0_wf)
    reset_counts()
    sol_w, cl_w, s_cold = worm_solve(dev, torch.float32, True, x0_wf)
    check_counts("f32 worm replan, cold", EXPECTED_WORM_COLD)
    check_solution(sol_w, cost0, "f32 worm replan, cold")
    share = float(cl_w.cmask.amax(-1).mean())
    share_c = float(cl_w.cmask[..., :24].amax(-1).mean())
    log(f"  returned classes: {share:.4f} of the (world, step) points with a clamping row, "
        f"{share_c:.4f} with a clamping contact row, {int((cl_w.us != 0).sum())} UPPER rows")
    if not share_c > 0.0:
        raise AssertionError("no point of the worm replan has a clamping contact row")
    # warm replans thread u and the classes as bench.py's _time_solves does
    cost0_warm = worm_cost0(dev, torch.float32, x0_wf, sol_w.u, cl_w)
    reset_counts()
    sol_w2, cl_w2, s_warm = worm_solve(dev, torch.float32, True, x0_wf, classes=cl_w,
                                       u0=sol_w.u)
    counts_w = check_counts("f32 worm replan, warm", EXPECTED_WORM_WARM)
    check_solution(sol_w2, cost0_warm, "f32 worm replan, warm")
    times, warm = [], (sol_w2.u, cl_w2)
    for _ in range(3):
        sol_t, cl_t, s = worm_solve(dev, torch.float32, True, x0_wf, classes=warm[1],
                                    u0=warm[0])
        times.append(s)
        warm = (sol_t.u, cl_t)
    worm_rate = WORM_B / (sum(times) / len(times))
    log(f"  f32 worm replan: cold {s_cold:.4f} s, first warm {s_warm:.4f} s, warm "
        f"{[round(t, 4) for t in times]} s -> {worm_rate:.1f} solves/s, replan "
        f"{1e3 * sum(times) / len(times):.2f} ms (B={WORM_B})")
    model_w = worm_model(dev, torch.float32)
    rc_w, fc_w = worm_costs(model_w)
    x0_wt = torch.tensor(x0_wf, dtype=torch.float32, device=dev)
    profile_solve("f32 worm replan (warm)", lambda: solve_contact_mpc_batch(
        model_w, x0_wt, warm[0], rc_w, fc_w, worm_config(), outer_iters=1, classes=warm[1],
        class_refresh="pointwise"))

    slice_counts, slice_rates = phase_11_12(dev, records, work, (sol_w.u, cl_w),
                                            (x0_w, sol_p_w), full_w)
    del full_w
    serve_cold_ms, serve_warm_ms, serve_ms = phase_serving(dev, smi)

    out = []
    for name in list(KERNELS) + list(CONTACT_KERNELS) + list(WORM_KERNELS) + list(SLICE_KERNELS):
        b, ops = work[name]
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        abs_err, ms, plain_ms = records[name]
        if name in KERNELS:
            launches = counts[name]
        elif name in CONTACT_KERNELS:
            launches = counts_c[CONTACT_COUNTER[name]]
        elif name in WORM_KERNELS:
            launches = counts_w[WORM_COUNTER[name]]
        else:
            launches = slice_counts[name]
        out.append({
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1], "launches": launches,
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "design": DESIGN[name],
        })
        log(f"  {name}: least bytes {b} ({t_bytes:.5f} ms), operations {ops} "
            f"({t_ops:.5f} ms)")
    log(f"{elapsed()} done: contact-free {rate:.1f} solves/s (B={B_FULL}); contact "
        f"{contact_rates[False]:.1f} (stock limits) and {contact_rates[True]:.1f} (narrowed) "
        f"solves/s (B={B_CONTACT}); worm {worm_rate:.1f} solves/s (B={WORM_B}), with "
        f"linearize=\"jvp\" {slice_rates['jvp']:.1f}, with \"split\" "
        f"{slice_rates['split']:.1f}, with \"chain\" {slice_rates['chain']:.1f}; serving "
        f"edge: replan cold {serve_cold_ms:.2f} ms, warm {serve_warm_ms:.2f} ms, control_now "
        f"median {serve_ms:.4f} ms; build {nvcc_s:.1f} s")
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
