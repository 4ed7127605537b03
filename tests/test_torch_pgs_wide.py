"""K7's shared-memory body for wide LCPs (csrc/lcp_wide.cu ``pgs_wide``),
built for the host with g++ and run on 32 fibers of one host thread, one
per lane (``FiberGroup`` in csrc/lane_group.cuh), against ``pgs_solve`` in
f64 on the 62 catapult_swing LCPs of tests/golden/world_lcp_golden.npz (m
= 129, 41 contact slots and 3 limited tails) from zero, and on every
fourth of them warm from half the reference's own answers, at SWEEPS
sweeps (each row a barrier of 32 fiber switches; the card runs 60 and
10,000 against the plain version and the reference in chip_smoke.py
phase 16a, A staged in shared memory). The body keeps the residual w = A
x - b current instead of recomputing each row's dot product, so it
rounds otherwise than pgs_solve: the solutions part by at most rel 1e-12
of each LCP's largest impulse."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nimblephysics_tpu_torch.ops.lcp import pgs_solve

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "nimblephysics_tpu_torch", "csrc")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "world_lcp_golden.npz")
SWEEPS = 20

# Reads "m n iters", findex (m ints), then n LCPs (A row-major, b, lo, hi,
# fscale, x0); writes each LCP's solution by pgs_wide on kK7WideGroup
# fibers.
MAIN = r"""
#include <cstdio>
#include <vector>
#include "lcp_wide.cu"

int main() {
  constexpr int M = 129, G = nptt::kK7WideGroup;
  int m, n, iters;
  if (scanf("%d %d %d", &m, &n, &iters) != 3 || m != M) return 1;
  std::vector<int> fi(M);
  for (auto& f : fi) if (scanf("%d", &f) != 1) return 1;
  std::vector<double> buf((size_t)M * M + 5 * M), out(M);
  for (int k = 0; k < n; ++k) {
    for (auto& x : buf) if (scanf("%lf", &x) != 1) return 1;
    const double* b = buf.data() + M * M;
    nptt::FiberGroup<G>::run([&](nptt::FiberGroup<G> g) {
      nptt::pgs_wide<double, M, G>(g, buf.data(), fi.data(), b, b + M, b + 2 * M, b + 3 * M,
                                   b + 4 * M, iters, out.data());
    });
    for (int i = 0; i < M; ++i) printf("%.17g ", out[i]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def wide_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the K7 body cannot be built for the host")
    d = tmp_path_factory.mktemp("pgs_wide")
    (d / "main.cpp").write_text(MAIN)
    exe = d / "main"
    subprocess.run(["g++", "-std=c++17", "-O2", "-pthread", "-I", CSRC, str(d / "main.cpp"),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)
    return exe


def catapult_lcps():
    d = np.load(GOLDEN)
    ps = [p for p in range(int(d["n_problems"])) if "catapult_swing" in str(d[f"w{p}_name"])]
    get = lambda k: np.stack([d[f"w{p}_{k}"] for p in ps])  # noqa: E731
    findex = tuple(int(f) for f in d[f"w{ps[0]}_findex"])
    assert all(tuple(d[f"w{p}_findex"]) == findex for p in ps)
    return [get(k) for k in ("A", "b", "lo", "hi", "fscale", "x_ref")], findex


def run_wide(exe, A, b, lo, hi, fs, x0, findex, iters):
    lines = [f"{b.shape[1]} {b.shape[0]} {iters}", " ".join(map(str, findex))]
    for k in range(b.shape[0]):
        lines.append(" ".join(repr(float(v)) for v in np.concatenate(
            [A[k].ravel(), b[k], lo[k], hi[k], fs[k], x0[k]])))
    out = subprocess.run([str(exe)], input="\n".join(lines), capture_output=True, text=True,
                         check=True, timeout=600).stdout
    return np.array([[float(t) for t in line.split()] for line in out.strip().splitlines()])


@pytest.mark.parametrize("start", ["zero", "warm"])
def test_pgs_wide_matches_pgs_solve_on_catapult_lcps(wide_exe, start):
    (A, b, lo, hi, fs, x_ref), findex = catapult_lcps()
    assert A.shape == (62, 129, 129) and sum(f >= 0 for f in findex) == 82
    if start == "zero":
        x0 = np.zeros_like(b)
    else:  # every fourth LCP, from half the reference's answer
        A, b, lo, hi, fs, x_ref = (a[::4] for a in (A, b, lo, hi, fs, x_ref))
        x0 = 0.5 * x_ref
    got = run_wide(wide_exe, A, b, lo, hi, fs, x0, findex, SWEEPS)
    want = pgs_solve(*(torch.tensor(a) for a in (A, b, lo, hi, fs, x0)), findex,
                     SWEEPS).numpy()
    scale = np.abs(want).max(1, keepdims=True)
    assert (scale > 0.0).all()
    err = float((np.abs(got - want) / scale).max())
    assert err <= 1e-12, err
    # normal rows clamp at zero and push in these LCPs (their friction
    # scales are 0, so the friction rows' coupled bounds close at 0)
    normal = want[:, [i for i, f in enumerate(findex) if f < 0]]
    assert (normal == 0.0).any() and (normal > 0.0).any()
    assert not fs.any()
