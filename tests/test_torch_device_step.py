"""The device step of the CUDA kernels (csrc/step.cuh), compiled as host
C++ with g++: its values and the linearize kernel's thread body (the step
on dual numbers) against the port's plain step and its jacfwd at 1e-12 in
f64, and its operations by kind against ``device_step.step_op_kinds``, the
count the kernels' least-work bounds use. Models: pendulum, the inverted
double pendulum (a weld behind two revolutes) and cartpole, at points from
numpy with a fixed seed. Also: the packed model follows in-place edits of
the Model's leaves."""

import functools
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nimblephysics_tpu_torch.models import builders
from nimblephysics_tpu_torch.ops import device_step
from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_for_trace, linearize_plain

CSRC = pathlib.Path(device_step.__file__).resolve().parent.parent / "csrc"
KINDS = ("add", "add_c", "mul", "mul_c", "div", "sin", "cos", "sqrt")
MODELS = ("pendulum", "inverted_double_pendulum", "cartpole")

# Reads "nb nq na n nr ni", the packed reals and ints, then n points (x, u);
# writes the operation counts of one step at the first point by kind, then
# per point the plain step's (q', v') and the linearize thread bodies'
# (fx, fu).
HOST_MAIN = r"""
#include <cstdio>
#include <vector>
#include "linearize.cu"

namespace nptt {
long long g_ops[8];  // add, add_c, mul, mul_c, div, sin, cos, sqrt
struct C {
  double v;
  C() : v(0) {}
  C(double x) : v(x) {}
};
inline C operator+(C a, C b) { ++g_ops[0]; return C(a.v + b.v); }
inline C operator-(C a, C b) { ++g_ops[0]; return C(a.v - b.v); }
inline C operator-(C a) { ++g_ops[0]; return C(-a.v); }
inline C operator-(double a, C b) { ++g_ops[0]; return C(a - b.v); }
inline C operator+(C a, double b) { ++g_ops[1]; return C(a.v + b); }
inline C operator+(double a, C b) { ++g_ops[1]; return C(a + b.v); }
inline C operator-(C a, double b) { ++g_ops[1]; return C(a.v - b); }
inline C operator*(C a, C b) { ++g_ops[2]; return C(a.v * b.v); }
inline C operator*(C a, double b) { ++g_ops[3]; return C(a.v * b); }
inline C operator*(double a, C b) { ++g_ops[3]; return C(a * b.v); }
inline C operator/(C a, double b) { ++g_ops[3]; return C(a.v / b); }
inline C operator/(C a, C b) { ++g_ops[4]; return C(a.v / b.v); }
inline C operator/(double a, C b) { ++g_ops[4]; return C(a / b.v); }
inline C nsin(C x) { ++g_ops[5]; return C(std::sin(x.v)); }
inline C ncos(C x) { ++g_ops[6]; return C(std::cos(x.v)); }
inline C nsqrt(C x) { ++g_ops[7]; return C(std::sqrt(x.v)); }
inline double val(C x) { return x.v; }
}  // namespace nptt

template <int NB, int NQ, int NA>
void run(const double* P, const int* I, const std::vector<double>& pts, int n) {
  constexpr int NX = 2 * NQ, K = NX + NA;
  using nptt::C;
  C q[NQ], v[NQ], u[NA], qn[NQ], vn[NQ];
  for (int i = 0; i < NQ; ++i) { q[i] = C(pts[i]); v[i] = C(pts[NQ + i]); }
  for (int a = 0; a < NA; ++a) u[a] = C(pts[NX + a]);
  nptt::device_step<double, C, NB, NQ, NA>(P, I, q, v, u, qn, vn);
  for (int k = 0; k < 8; ++k) printf("%lld ", nptt::g_ops[k]);
  printf("\n");
  std::vector<double> xs(n * NX), us(n * NA), fx(n * NX * NX), fu(n * NX * NA);
  for (int p = 0; p < n; ++p) {
    for (int i = 0; i < NX; ++i) xs[p * NX + i] = pts[p * K + i];
    for (int a = 0; a < NA; ++a) us[p * NA + a] = pts[p * K + NX + a];
  }
  for (long long t = 0; t < (long long)n * K; ++t)
    nptt::linearize_thread<double, NB, NQ, NA>(t, P, I, xs.data(), us.data(), fx.data(), fu.data());
  for (int p = 0; p < n; ++p) {
    double qd[NQ], vd[NQ], qo[NQ], vo[NQ];
    for (int i = 0; i < NQ; ++i) { qd[i] = xs[p * NX + i]; vd[i] = xs[p * NX + NQ + i]; }
    nptt::device_step<double, double, NB, NQ, NA>(P, I, qd, vd, &us[p * NA], qo, vo);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", qo[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", vo[i]);
    for (int i = 0; i < NX * NX; ++i) printf("%.17g ", fx[p * NX * NX + i]);
    for (int i = 0; i < NX * NA; ++i) printf("%.17g ", fu[p * NX * NA + i]);
    printf("\n");
  }
}

int main() {
  int nb, nq, na, n, nr, ni;
  if (scanf("%d %d %d %d %d %d", &nb, &nq, &na, &n, &nr, &ni) != 6) return 2;
  std::vector<double> P(nr), pts(n * (2 * nq + na));
  std::vector<int> I(ni);
  for (auto& x : P) if (scanf("%lf", &x) != 1) return 2;
  for (auto& x : I) if (scanf("%d", &x) != 1) return 2;
  for (auto& x : pts) if (scanf("%lf", &x) != 1) return 2;
#define RUN(NB, NQ, NA) \
  if (nb == NB && nq == NQ && na == NA) { run<NB, NQ, NA>(P.data(), I.data(), pts, n); return 0; }
  RUN(1, 1, 1)
  RUN(4, 3, 1)
  RUN(2, 2, 1)
  return 3;
}
"""


@pytest.fixture(scope="module")
def host_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the device step cannot be built for the host")
    d = tmp_path_factory.mktemp("device_step")
    (d / "host_main.cpp").write_text(HOST_MAIN)
    exe = d / "host_main"
    subprocess.run(["g++", "-std=c++17", "-O0", "-I", str(CSRC), str(d / "host_main.cpp"),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)
    return exe


def model_named(name):
    return getattr(builders, name)(dtype=torch.float64, device="cpu")


def points(model, n=4, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.6, 0.6, (n, 2 * model.nq))
    x[-1, : model.nq] = 0.0         # joints at zero: Rodrigues' Taylor branch
    return x, rng.standard_normal((n, model.num_actions))


@functools.lru_cache(maxsize=None)
def run_host(exe, name):
    """(model, x, u, operation counts by kind, one output row per point)."""
    model = model_named(name)
    x, u = points(model)
    P, I = device_step.pack_model(model)
    head = (model.num_bodies, model.nq, model.num_actions, x.shape[0], P.numel(), I.numel())
    text = "\n".join([" ".join(str(v) for v in head),
                      " ".join(repr(v) for v in P.tolist()),
                      " ".join(str(v) for v in I.tolist()),
                      " ".join(repr(float(v)) for v in np.concatenate([x, u], axis=1).ravel())])
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()
    counts = dict(zip(KINDS, (int(c) for c in out[0].split())))
    rows = np.array([[float(v) for v in line.split()] for line in out[1:]])
    return model, x, u, counts, rows


@pytest.mark.parametrize("name", MODELS)
def test_device_step_matches_plain_step(host_exe, name):
    model, x, u, _, rows = run_host(host_exe, name)
    nx = 2 * model.nq
    want = dyn_for_trace(model)(torch.tensor(x), torch.tensor(u)).numpy()
    np.testing.assert_allclose(rows[:, :nx], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_linearize_thread_matches_jacfwd(host_exe, name):
    model, x, u, _, rows = run_host(host_exe, name)
    nx, na, n = 2 * model.nq, model.num_actions, x.shape[0]
    fx, fu = linearize_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None])
    np.testing.assert_allclose(rows[:, nx:nx + nx * nx], fx.reshape(n, -1).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rows[:, nx + nx * nx:], fu.reshape(n, nx * na).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_step_op_count_matches_device_step(host_exe, name):
    """The closed-form count equals what the step does, kind by kind, at a
    point off the Taylor branch of Rodrigues' formula."""
    model, _, _, counts, _ = run_host(host_exe, name)
    want = device_step.step_op_kinds(model)
    assert counts == {k: want.get(k, 0) for k in KINDS}


def test_pack_model_follows_in_place_edits():
    model = builders.cartpole(dtype=torch.float64, device="cpu")
    P0, I0 = device_step.pack_model(model)
    assert device_step.pack_model(model)[0] is P0
    with torch.no_grad():
        model.mass[1] *= 1.1
        model.gravity[1] = -3.0
    P1, I1 = device_step.pack_model(model)
    fresh = builders.cartpole(dtype=torch.float64, device="cpu")
    with torch.no_grad():
        fresh.mass[1] *= 1.1
        fresh.gravity[1] = -3.0
    assert not torch.equal(P1, P0)
    assert torch.equal(P1, device_step.pack_model(fresh)[0])
    assert torch.equal(I1, I0)
