#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nimblephysics_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path, the contact-free batched iLQR replan of
``bench.py``'s cartpole row (B=4096 worlds, H=100, 8 iterations, 6 alphas),
on the card, after building the CUDA kernels and holding each one against
its plain PyTorch version. Phases:

  1. environment: torch, the card, its power limit (nvidia-smi);
  2. build: one nvcc call for all kernels (skipped when already built);
  3. each kernel against its plain version at B=512, T=100, in f64
     (rel 1e-9) and f32 (rel 2e-4), and the Riccati kernel's second
     instance, (nx, na) = (6, 3); then each kernel at the main path's
     shapes in f32 with kernel and plain times;
  4. the slice at full width: f64 kernel path against the plain path on the
     card (cost within rel 1e-10; u within 1e-8 abs in every world where
     the plain path run from x0 +- 1e-13 moves u by less than that, and
     within twice that world's own move in the others; final cost <=
     initial cost in every world), then
     the f32 kernel path once with the launch counters set to 0 before and
     read after, three warm timed runs (solves/s) and one profiled solve;
  5. a JSON line with every kernel's numbers, then the result line.

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
from nimblephysics_tpu_torch.ops.cuda_linearize import linearize, linearize_plain
from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward, riccati_backward_plain
from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_gains, rollout_gains_plain
from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost
from nimblephysics_tpu_torch.trajectory.ilqr import ILQRConfig, _cost_derivatives, ilqr_solve_batch

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
EXPECTED_LAUNCHES = {"riccati_backward": ITERS, "linearize": ITERS,
                     "rollout_gains": ITERS + 1}
REPLACES = {
    "riccati_backward": ("nimblephysics_tpu_torch/csrc/riccati.cu",
                         "nimblephysics_tpu/ops/pallas_riccati.py:329"),
    "linearize": ("nimblephysics_tpu_torch/csrc/linearize.cu",
                  "nimblephysics_tpu/ops/pallas_linearize.py:205"),
    "rollout_gains": ("nimblephysics_tpu_torch/csrc/rollout.cu",
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


def compare(name, args):
    """(max abs err, max abs err / max |plain|) of the wrapper's outputs
    against the plain version's; the ok flags must agree exactly."""
    out_k = KERNELS[name](*args)
    sync()
    out_p = PLAIN[name](*args)
    abs_err, rel_err = 0.0, 0.0
    for a, b in zip(out_k, out_p):
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: ok flags differ in {int((a != b).sum())} worlds")
            continue
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(float(b.abs().max()), 1e-30))
    return abs_err, rel_err


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


def profile_solve(dev, x0_np, T):
    """One warm f32 kernel-path solve under torch.profiler: the device's
    busy time (the union of its kernel and copy intervals; CPU op rows,
    which repeat their kernels' time, are left out) against the host clock,
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = model_for(dev, torch.float32)
    rc, fc = costs_for(model)
    x0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    u0 = torch.zeros((x0.shape[0], T, 1), dtype=torch.float32, device=dev)
    cfg = ILQRConfig(iters=ITERS, alphas=ALPHAS)
    ilqr_solve_batch(model, x0, u0, rc, fc, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ilqr_solve_batch(model, x0, u0, rc, fc, cfg)
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
    log(f"  profiled f32 solve: wall {wall * 1e3:.2f} ms (profiler on), device busy "
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
    for fn in KERNELS.values():
        fn.launches = 0


def check_counts(label):
    counts = {n: fn.launches for n, fn in KERNELS.items()}
    log(f"  launches ({label}): {counts}, expected {EXPECTED_LAUNCHES}")
    if counts != EXPECTED_LAUNCHES or min(counts.values()) == 0:
        raise AssertionError(f"{label}: launch counts {counts}")
    return counts


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
    check_counts("f64 kernel path")
    sol_p, _, s_p = solve(dev, torch.float64, False, x0_np, H)
    # Near convergence two alphas of the line search can give costs within
    # an ulp of each other; which one wins is then decided by rounding, and
    # u moves by |alpha_1 - alpha_2| |k| (~1e-6) between any two roundings
    # of the same solve. The kernel path's costs differ from the plain
    # path's by up to rel ~1e-13, so the plain path is run again from x0
    # moved by +-X0_SHIFT, which moves its costs by about as much and u
    # itself by ~1e-12. u is held to 1e-8 abs in every world where neither
    # run moves u by 1e-8, and elsewhere to U_SENS_FACTOR times that
    # world's own move; the cost to rel 1e-10 everywhere.
    sens_w = torch.zeros(B_FULL, dtype=torch.float64, device=dev)
    for shift in (X0_SHIFT, -X0_SHIFT):
        sol_s = solve(dev, torch.float64, False, x0_np + shift, H)[0]
        sens_w = torch.maximum(sens_w, (sol_s.u - sol_p.u).abs().amax(dim=(1, 2)))
    sensitive = sens_w >= U_TOL_F64
    u_tol_w = torch.where(sensitive, U_SENS_FACTOR * sens_w, U_TOL_F64)
    du_w = (sol_k.u - sol_p.u).abs().amax(dim=(1, 2))
    bad = int((du_w > u_tol_w).sum())
    dc = float(((sol_k.cost - sol_p.cost).abs() / sol_p.cost.abs()).max())
    log(f"  f64: kernel path {s_k:.3f} s, plain path {s_p:.3f} s; the plain path from x0 "
        f"+-{X0_SHIFT:.0e} moves u by >= {U_TOL_F64:.0e} in {int(sensitive.sum())} of "
        f"{B_FULL} worlds: {sensitive.nonzero().flatten().tolist()[:10]}, by "
        f"{sens_w[sensitive].tolist()[:10]}")
    log(f"  |u_kernel - u_plain|: max {float(du_w.where(~sensitive, 0.0).max()):.3e} in the "
        f"other worlds (tol {U_TOL_F64:.0e}); {du_w[sensitive].tolist()[:10]} in those "
        f"(tol {U_SENS_FACTOR:g} x their own move); {bad} worlds out of tolerance; "
        f"max rel cost diff {dc:.3e} (tol {COST_RTOL_F64:.0e})")
    if bad:
        worst = torch.nonzero(du_w > u_tol_w).flatten()[:10].tolist()
        raise AssertionError("f64 kernel path and plain path disagree on u in worlds "
                             f"{worst}: |du| {du_w[worst].tolist()}, their own move "
                             f"{sens_w[worst].tolist()}")
    if not dc <= COST_RTOL_F64:
        raise AssertionError("f64 kernel path and plain path disagree on the cost")
    check_solution(sol_k, cost0_64, "f64 kernel path")

    reset_counts()
    sol32, cost0_32, s_first = solve(dev, torch.float32, True, x0_np, H)
    counts = check_counts("f32 main path")
    check_solution(sol32, cost0_32, "f32 kernel path")
    times = [solve(dev, torch.float32, True, x0_np, H)[2] for _ in range(3)]
    rate = B_FULL / (sum(times) / len(times))
    log(f"  f32 kernel path: first {s_first:.4f} s, warm {[round(t, 4) for t in times]} s "
        f"-> {rate:.1f} solves/s (B={B_FULL}, H={H})")

    profile_solve(dev, x0_np, H)
    derivs_ms = time_ms(lambda: _cost_derivatives(*full["rollout_gains"][1:3],
                                                  full["rollout_gains"][4],
                                                  full["rollout_gains"][5]), 5)
    log(f"  cost derivatives (torch.func, B={B_FULL}, T={H}, f32): {derivs_ms:.3f} ms per call")

    out = []
    for name in KERNELS:
        b, ops = work[name]
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        abs_err, ms, plain_ms = records[name]
        out.append({
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1], "launches": counts[name],
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"  {name}: least bytes {b} ({t_bytes:.5f} ms), operations {ops} "
            f"({t_ops:.5f} ms)")
    log(f"{elapsed()} done: {rate:.1f} solves/s; nvcc {nvcc_s:.1f} s")
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
