"""The device step of the CUDA kernels (csrc/step.cuh), compiled as host
C++ with g++: its values and the linearize kernel's thread body (the step
on dual numbers) against the port's plain step and its jacfwd at 1e-12 in
f64, and its operations by kind against ``device_step.step_op_kinds``, the
count the kernels' least-work bounds use. Models: pendulum, the inverted
double pendulum (a weld behind two revolutes) and cartpole, at points from
numpy with a fixed seed. Also: the packed model follows in-place edits of
the Model's leaves. Then the constrained steps on the narrowed-limit
cartpole (K2 with classes, K4, K6) and on the jump worm (a translational2d
root, 8 box-corner contact slots with friction coupling: K2 with classes,
K4's and K5's lane-group bodies, and K7's thread and group bodies)."""

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
# Reads "nb nq na n nr ni", the packed reals and ints, then n points (x, u);
# writes the operation counts of one step at the first point by kind, then
# those of K3's body for that point (its nx + na direction threads summed),
# then per point the plain step's (q', v') and K3's (fx, fu).
HOST_MAIN = r"""
#include <cstdio>
#include <vector>
#include "linearize_free.cu"

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
// dual numbers over the counting scalar, with the model's constants as double
using DC = Dual<C>;
inline DC operator+(DC a, double b) { return DC(a.v + b, a.d); }
inline DC operator+(double a, DC b) { return DC(a + b.v, b.d); }
inline DC operator-(DC a, double b) { return DC(a.v - b, a.d); }
inline DC operator-(double a, DC b) { return DC(a - b.v, -b.d); }
inline DC operator*(DC a, double b) { return DC(a.v * b, a.d * b); }
inline DC operator*(double a, DC b) { return DC(a * b.v, a * b.d); }
inline DC operator/(DC a, double b) { return DC(a.v / b, a.d / b); }
inline DC operator/(double a, DC b) { C q = a / b.v; return DC(q, -q * b.d / b.v); }
inline double val(DC x) { return x.v.v; }
}  // namespace nptt

static void print_ops() {
  for (int k = 0; k < 8; ++k) printf("%lld ", nptt::g_ops[k]);
  printf("\n");
  for (int k = 0; k < 8; ++k) nptt::g_ops[k] = 0;
}

template <int NB, int NQ, int NA>
void run(const double* P, const int* I, const std::vector<double>& pts, int n) {
  constexpr int NX = 2 * NQ, K = NX + NA;
  using nptt::C;
  std::vector<double> xs(n * NX), us(n * NA), fx(n * NX * NX), fu(n * NX * NA);
  for (int p = 0; p < n; ++p) {
    for (int i = 0; i < NX; ++i) xs[p * NX + i] = pts[p * K + i];
    for (int a = 0; a < NA; ++a) us[p * NA + a] = pts[p * K + NX + a];
  }
  {
    C q[NQ], v[NQ], u[NA], qn[NQ], vn[NQ];
    for (int i = 0; i < NQ; ++i) { q[i] = C(xs[i]); v[i] = C(xs[NQ + i]); }
    for (int a = 0; a < NA; ++a) u[a] = C(us[a]);
    nptt::device_step<double, C, NB, NQ, NA>(P, I, q, v, u, qn, vn);
    print_ops();
    std::vector<C> fxc(NX * NX), fuc(NX * NA);
    for (int k = 0; k < K; ++k)
      nptt::linearize_dir<double, C, NB, NQ, NA>(0, k, P, I, xs.data(), us.data(), fxc.data(),
                                                 fuc.data());
    print_ops();
  }
  for (long long p = 0; p < n; ++p)
    for (int k = 0; k < K; ++k)
      nptt::linearize_dir<double, double, NB, NQ, NA>(p, k, P, I, xs.data(), us.data(), fx.data(),
                                                      fu.data());
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
    counts = [dict(zip(KINDS, (int(c) for c in line.split()))) for line in out[:2]]
    rows = np.array([[float(v) for v in line.split()] for line in out[2:]])
    return model, x, u, counts, rows


@pytest.mark.parametrize("name", MODELS)
def test_device_step_matches_plain_step(host_exe, name):
    model, x, u, _, rows = run_host(host_exe, name)
    nx = 2 * model.nq
    want = dyn_for_trace(model)(torch.tensor(x), torch.tensor(u)).numpy()
    np.testing.assert_allclose(rows[:, :nx], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_linearize_thread_matches_jacfwd(host_exe, name):
    """K3's body (csrc/linearize_free.cu linearize_dir: a thread per (point,
    direction), each direction's kind keeping plain what it leaves fixed)
    against jacfwd of the plain step."""
    model, x, u, _, rows = run_host(host_exe, name)
    nx, na, n = 2 * model.nq, model.num_actions, x.shape[0]
    fx, fu = linearize_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None])
    np.testing.assert_allclose(rows[:, nx:nx + nx * nx], fx.reshape(n, -1).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rows[:, nx + nx * nx:], fu.reshape(n, nx * na).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_step_op_count_matches_device_step(host_exe, name):
    """The closed-form counts equal what the code does, kind by kind, at a
    point off the Taylor branch of Rodrigues' formula: the step's
    (step_op_kinds) and K3's body's per point (k3_point_op_kinds)."""
    model, _, _, counts, _ = run_host(host_exe, name)
    want = device_step.step_op_kinds(model)
    assert counts[0] == {k: want.get(k, 0) for k in KINDS}
    # the typed count (K3's) of the step all dual is the plain count plus
    # one forward-mode tangent of every operation
    assert device_step.typed_step_op_kinds(model, True, True, True) == \
        +(want + device_step._tangent_kinds(want))
    kinds = device_step.k3_point_op_kinds(model)
    assert counts[1] == {k: kinds.get(k, 0) for k in KINDS}
    # K3's bound: the least form (the step once, each direction's tangent
    # alone) lies below what the body does and below one step and nx + na
    # whole tangents
    plain, tangent = device_step.step_ops(model)
    least = device_step.k3_least_ops(model)
    assert least < sum(counts[1].values())
    assert least < plain + (2 * model.nq + model.num_actions) * tangent


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


# The constrained device code (csrc/step.cuh frozen_step and class_step) and
# the thread bodies of K2 with classes, K4 and K6, built for the host.
# Reads "nb nq na m n nr ni n_cg", the packed reals and ints, the cost
# weights (2 nq + na + nx), then n points (x, u, cmask); writes the
# operation counts by kind of frozen_step on the counting scalar, of
# class_step on it, of frozen_step on dual numbers over it (a plain step
# plus one tangent), and of K4's one-thread body (linearize_point) on it at
# the first point's (x, u) with no row clamping (where the tie rule of
# max|Qf| adds nothing); then per point frozen_step's (q', v'),
# class_step's (q', v', cmask) and K4's body's (fx, fu); then K6's and K2's
# threads run over the n points as one trajectory (x0 = the first point's
# x, u_t = the points' u, K2 with zero gains and the points' cmask): per
# step K6's (x', cmask) and K2's x', and K2's cost last.
CONTACT_MAIN = r"""
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>
#include "linearize.cu"
#include "rollout.cu"

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
// dual numbers over the counting scalar, with the model's constants as double
using DC = Dual<C>;
inline DC operator+(DC a, double b) { return DC(a.v + b, a.d); }
inline DC operator+(double a, DC b) { return DC(a + b.v, b.d); }
inline DC operator-(DC a, double b) { return DC(a.v - b, a.d); }
inline DC operator-(double a, DC b) { return DC(a - b.v, -b.d); }
inline DC operator*(DC a, double b) { return DC(a.v * b, a.d * b); }
inline DC operator*(double a, DC b) { return DC(a * b.v, a * b.d); }
inline DC operator/(DC a, double b) { return DC(a.v / b, a.d / b); }
inline DC operator/(double a, DC b) { C q = a / b.v; return DC(q, -q * b.d / b.v); }
inline double val(DC x) { return x.v.v; }
}  // namespace nptt

static void print_ops() {
  for (int k = 0; k < 8; ++k) printf("%lld ", nptt::g_ops[k]);
  printf("\n");
  for (int k = 0; k < 8; ++k) nptt::g_ops[k] = 0;
}

template <int NB, int NQ, int NA, int M>
void run(const double* P, const int* I, const double* w, const std::vector<double>& pts, int n,
         int n_cg) {
  constexpr int NX = 2 * NQ, K = NX + NA, E = NX + NA + M;
  using nptt::C;
  using nptt::DC;
  std::vector<double> xs(n * NX), us(n * NA), cms(n * M), zs(n * M, 0.0);
  for (int p = 0; p < n; ++p) {
    for (int i = 0; i < NX; ++i) xs[p * NX + i] = pts[p * E + i];
    for (int a = 0; a < NA; ++a) us[p * NA + a] = pts[p * E + NX + a];
    for (int r = 0; r < M; ++r) cms[p * M + r] = pts[p * E + NX + NA + r];
  }
  {
    C q[NQ], v[NQ], u[NA], qn[NQ], vn[NQ];
    double cmo[M];
    for (int i = 0; i < NQ; ++i) { q[i] = C(xs[i]); v[i] = C(xs[NQ + i]); }
    for (int a = 0; a < NA; ++a) u[a] = C(us[a]);
    nptt::frozen_step<double, C, NB, NQ, NA, M, 0>(P, I, q, v, u, cms.data(), zs.data(), n_cg, qn,
                                                  vn);
    print_ops();
    nptt::class_step<double, C, NB, NQ, NA, M>(P, I, q, v, u, qn, vn, cmo);
    print_ops();
    DC qd[NQ], vd[NQ], ud[NA], qnd[NQ], vnd[NQ];
    for (int i = 0; i < NQ; ++i) { qd[i] = DC(C(xs[i]), C(1.0)); vd[i] = DC(C(xs[NQ + i])); }
    for (int a = 0; a < NA; ++a) ud[a] = DC(C(us[a]));
    nptt::frozen_step<double, DC, NB, NQ, NA, M, 0>(P, I, qd, vd, ud, cms.data(), zs.data(), n_cg,
                                                   qnd, vnd);
    print_ops();
    std::vector<C> fxc(NX * NX), fuc(NX * NA);
    nptt::LocalSlots<C, nptt::kPointSlots<NQ, NA, M>> stc;
    nptt::linearize_point<double, C, NB, NQ, NA, M, 0, nptt::kK4PointRhs>(
        stc, 0, n_cg, P, I, xs.data(), us.data(), zs.data(), zs.data(), fxc.data(), fuc.data());
    print_ops();
  }
  std::vector<double> fx(n * NX * NX), fu(n * NX * NA);
  nptt::LocalSlots<double, nptt::kPointSlots<NQ, NA, M>> st;
  for (long long p = 0; p < n; ++p)
    nptt::linearize_point<double, double, NB, NQ, NA, M, 0, nptt::kK4PointRhs>(
        st, p, n_cg, P, I, xs.data(), us.data(), cms.data(), zs.data(), fx.data(), fu.data());
  for (int p = 0; p < n; ++p) {
    double qo[NQ], vo[NQ], qc[NQ], vc[NQ], cmo[M];
    nptt::frozen_step<double, double, NB, NQ, NA, M, 0>(P, I, &xs[p * NX], &xs[p * NX + NQ],
                                                        &us[p * NA], &cms[p * M], &zs[p * M], n_cg,
                                                        qo, vo);
    nptt::class_step<double, double, NB, NQ, NA, M>(P, I, &xs[p * NX], &xs[p * NX + NQ],
                                                    &us[p * NA], qc, vc, cmo);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", qo[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", vo[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", qc[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", vc[i]);
    for (int r = 0; r < M; ++r) printf("%.17g ", cmo[r]);
    for (int i = 0; i < NX * NX; ++i) printf("%.17g ", fx[p * NX * NX + i]);
    for (int i = 0; i < NX * NA; ++i) printf("%.17g ", fu[p * NX * NA + i]);
    printf("\n");
  }
  // one trajectory of n steps from the first point: K6, then K2 (zero gains)
  std::vector<double> out(n * (NX + M)), xs_ref((n + 1) * NX, 0.0), Kg(n * NA * NX, 0.0),
      kf(n * NA, 0.0), xs2((n + 1) * NX), us2(n * NA);
  double alpha = 1.0, cost = 0.0;
  nptt::classes_thread<double, NB, NQ, NA, M>(0, 1, n, P, I, xs.data(), us.data(), out.data());
  nptt::rollout_thread<double, NB, NQ, NA, M, 0>(0, 1, n, n_cg, P, I, w, xs.data(),
                                                  xs_ref.data(), us.data(), Kg.data(), kf.data(),
                                                  &alpha, cms.data(), zs.data(), xs2.data(),
                                                  us2.data(), &cost);
  for (int t = 0; t < n; ++t) {
    for (int e = 0; e < NX + M; ++e) printf("%.17g ", out[t * (NX + M) + e]);
    for (int i = 0; i < NX; ++i) printf("%.17g ", xs2[(t + 1) * NX + i]);
    printf("\n");
  }
  printf("%.17g\n", cost);
}

// qdiv(a, b) and a / b as bit patterns, side by side, over zeros of both
// signs, a denormal, infinite, NaN and zero divisors and nonzero dividends
template <typename F, typename U>
static void print_qdiv() {
  const F inf = F(INFINITY), nan = F(NAN), tiny = std::numeric_limits<F>::denorm_min();
  const F as[] = {F(0), -F(0), F(0), -F(0), F(0), -F(0), F(0), -F(0), F(0), F(0), F(1), F(-2.5)};
  const F bs[] = {F(1.5), F(1.5), F(-3), F(-3), tiny, -tiny, inf, -inf, F(0), nan, F(3), F(7)};
  for (int k = 0; k < 12; ++k) {
    const F q = nptt::qdiv(as[k], bs[k]), r = as[k] / bs[k];
    U bq, br;
    std::memcpy(&bq, &q, sizeof(F));
    std::memcpy(&br, &r, sizeof(F));
    printf("%llx %llx ", (unsigned long long)bq, (unsigned long long)br);
  }
  printf("\n");
}

int main(int argc, char** argv) {
  if (argc > 1 && std::string(argv[1]) == "qdiv") {
    print_qdiv<double, unsigned long long>();
    print_qdiv<float, unsigned int>();
    return 0;
  }
  int nb, nq, na, m, n, nr, ni, n_cg;
  if (scanf("%d %d %d %d %d %d %d %d", &nb, &nq, &na, &m, &n, &nr, &ni, &n_cg) != 8) return 2;
  std::vector<double> P(nr), w(8 * nq + na), pts(n * (2 * nq + na + m));
  std::vector<int> I(ni);
  for (auto& x : P) if (scanf("%lf", &x) != 1) return 2;
  for (auto& x : I) if (scanf("%d", &x) != 1) return 2;
  for (auto& x : w) if (scanf("%lf", &x) != 1) return 2;
  for (auto& x : pts) if (scanf("%lf", &x) != 1) return 2;
#define RUN(NB, NQ, NA, M, NS) \
  if (nb == NB && nq == NQ && na == NA && m == M) { run<NB, NQ, NA, M>(P.data(), I.data(), w.data(), pts, n, n_cg); return 0; }
  NPTT_CONTACT_SHAPES(RUN)
  return 3;
}
"""

# m + 6, the default; a truncated PCG; one iteration, which stops short of
# the solution where two rows clamp (contact_points has such points), so
# that the implicit tangent and the derivative of the iteration differ
CG_DEPTHS = (10, 4, 1)


@pytest.fixture(scope="module")
def contact_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the device step cannot be built for the host")
    d = tmp_path_factory.mktemp("contact_step")
    (d / "contact_main.cpp").write_text(CONTACT_MAIN)
    exe = d / "contact_main"
    subprocess.run(["g++", "-std=c++17", "-O0", "-I", str(CSRC), str(d / "contact_main.cpp"),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)
    return exe


def limited_cartpole():
    """Cartpole with the narrowed limits of tests/test_frozen_contact.py."""
    m = builders.cartpole(dt=0.02, dtype=torch.float64, device="cpu")
    return m.replace(q_lower=torch.tensor([-0.6, -0.5], dtype=torch.float64),
                     q_upper=torch.tensor([0.6, 0.5], dtype=torch.float64))


def contact_points(n=8, seed=6):
    """Points at and beyond the limits, with velocities into them, strong
    pushes, and class masks with some rows clamping."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.7, 0.7, (n, 2))
    v = -np.sign(q) * rng.uniform(-0.5, 2.0, (n, 2))
    x = np.concatenate([q, -v], axis=1)
    u = rng.uniform(-40.0, 40.0, (n, 1))
    cm = (rng.uniform(size=(n, 4)) < 0.4).astype(np.float64)
    cm[0] = [1.0, 0.0, 0.0, 1.0]
    # the trajectory the thread bodies roll from the first point runs into
    # the upper limits
    x[0] = [0.55, 0.45, 1.5, 2.0]
    u[: n // 2] = 30.0
    return x, u, cm


@functools.lru_cache(maxsize=None)
def run_contact(exe, n_cg):
    """(model, x, u, cmask, operation counts of frozen_step, class_step,
    frozen_step on duals and K4's body, one row per point, one row per
    trajectory step, K2's trajectory cost)."""
    model = limited_cartpole()
    x, u, cm = contact_points()
    P, I = device_step.pack_model(model)
    w = np.concatenate([np.full(2, 0.1), np.zeros(2), np.full(1, 1e-3), np.full(4, 10.0),
                        np.zeros(8)])
    head = (model.num_bodies, model.nq, model.num_actions, 4, x.shape[0], P.numel(), I.numel(),
            n_cg)
    text = "\n".join([" ".join(str(v) for v in head),
                      " ".join(repr(v) for v in P.tolist()),
                      " ".join(str(v) for v in I.tolist()),
                      " ".join(repr(float(v)) for v in w),
                      " ".join(repr(float(v)) for v in np.concatenate([x, u, cm], axis=1).ravel())])
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()
    counts = [dict(zip(KINDS, (int(c) for c in line.split()))) for line in out[:4]]
    n = x.shape[0]
    rows = np.array([[float(v) for v in line.split()] for line in out[4:4 + n]])
    traj = np.array([[float(v) for v in line.split()] for line in out[4 + n:4 + 2 * n]])
    return model, x, u, cm, counts, rows, traj, float(out[4 + 2 * n])


@pytest.mark.parametrize("n_cg", CG_DEPTHS)
def test_frozen_and_class_steps_match_plain(contact_exe, n_cg):
    from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_frozen_for_trace
    from nimblephysics_tpu_torch.ops.frozen_contact import step_with_classes_for_trace

    model, x, u, cm, _, rows, _, _ = run_contact(contact_exe, n_cg)
    xt, ut, cmt = (torch.tensor(a) for a in (x, u, cm))
    frozen = dyn_frozen_for_trace(model, n_cg)(xt, ut, cmt, torch.zeros_like(cmt)).numpy()
    np.testing.assert_allclose(rows[:, :4], frozen, rtol=1e-12, atol=1e-12)
    x2, cm2, _ = step_with_classes_for_trace(model)(xt, ut)
    np.testing.assert_allclose(rows[:, 4:8], x2.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(rows[:, 8:12], cm2.numpy())
    assert 0 < cm2.sum() < cm2.numel()


def tie_rule_live(model, x, u, cm):
    """Per point, whether the tangent of reg = eps max(max|Qf|, 1)^2 by
    jnp's tie rule is live: an entry of Qf = C A R + (I - C) with both rows
    clamping attains max|Qf| >= 1 (the planner assembly's A, no slot)."""
    from nimblephysics_tpu_torch.ops import dynamics as td
    from nimblephysics_tpu_torch.ops.collide import detect_contacts
    from nimblephysics_tpu_torch.ops.contact import build_constraint_system

    xt, ut, c = torch.tensor(x), torch.tensor(u), torch.tensor(cm)
    q, v = xt[:, :model.nq], xt[:, model.nq:]
    kin = td.forward_kinematics(model, q)
    v_star = v + model.dt * td.aba(model, q, v, model.action_to_tau(ut), kin=kin)
    _, A, *_ = build_constraint_system(model, q, v_star, kin, detect_contacts(model, kin.T_wb),
                                       planner=True)
    Qf = c[:, :, None] * A * c[:, None, :] ** 2 + torch.diag_embed(1 - c)
    mx = Qf.abs().amax((1, 2))
    tied = (Qf.abs() == mx[:, None, None]) & ((c[:, :, None] * c[:, None, :]) != 0)
    return (tied.any((1, 2)) & (mx >= 1)).numpy()


@pytest.mark.parametrize("n_cg", CG_DEPTHS)
def test_linearize_split_thread_matches_implicit_jacfwd(contact_exe, n_cg):
    """K4's one-thread body (linearize_point: the primal once, each
    direction's tangent right-hand side through the factors of A, the
    tangent PCGs over the one Qf) against jacfwd of the plain frozen step,
    whose tangent through solve_frozen is the implicit one. The points
    include some where the tie rule's tangent of reg is live (a clamping
    row's entry of C A R, above 1, attains max|Qf|) and some where it is
    not; on every point the pole angle's direction carries dM, whose
    terms h = -M^-1 dM w and k = -dM pz enter its right-hand side."""
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_split_plain

    model, x, u, cm, _, rows, _, _ = run_contact(contact_exe, n_cg)
    live = tie_rule_live(model, x, u, cm)
    assert live.any() and not live.all()
    n = x.shape[0]
    cmt = torch.tensor(cm)[:, None]
    fx, fu = linearize_split_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                   (cmt, torch.zeros_like(cmt)), n_cg)
    np.testing.assert_allclose(rows[:, 12:28], fx.reshape(n, -1).numpy(), rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(rows[:, 28:32], fu.reshape(n, -1).numpy(), rtol=1e-11, atol=1e-11)


def test_linearize_split_thread_rejects_the_iterated_tangent(contact_exe, monkeypatch):
    """At one PCG iteration the derivative taken through the iteration is
    another Jacobian: the comparison above, at rel 1e-11, would reject a
    body that pushed its tangents through the PCG."""
    from torch_port_helpers import iterate_through_pcg

    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_split_plain

    model, x, u, cm, _, rows, _, _ = run_contact(contact_exe, 1)
    n = x.shape[0]
    cmt = torch.tensor(cm)[:, None]
    iterate_through_pcg(monkeypatch)
    fx, _ = linearize_split_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                  (cmt, torch.zeros_like(cmt)), 1)
    gap = np.abs(rows[:, 12:28] - fx.reshape(n, -1).numpy()).max() / np.abs(rows[:, 12:28]).max()
    assert gap > 1e-3, gap


def test_class_and_rollout_threads_match_plain(contact_exe):
    """K6's and K2's (with classes) thread bodies over one trajectory."""
    from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_classes_plain, rollout_gains_plain
    from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost

    model, x, u, cm, _, _, traj, cost = run_contact(contact_exe, 10)
    n = x.shape[0]
    x0, ut = torch.tensor(x[:1]), torch.tensor(u)[None]
    xs6, cl6 = rollout_classes_plain(model, x0, ut)
    np.testing.assert_allclose(traj[:, :4], xs6[0].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(traj[:, 4:8], cl6.cmask[0].numpy())
    assert 0 < cl6.cmask.sum() < cl6.cmask.numel()
    cmt = torch.tensor(cm)[None]
    xs2, _, c2 = rollout_gains_plain(
        model, QuadraticCost(model, wq=0.1, wu=1e-3), QuadraticFinalCost(model, wx=10.0), x0,
        torch.zeros(1, n + 1, 4, dtype=torch.float64), ut,
        torch.zeros(1, n, 1, 4, dtype=torch.float64), torch.zeros(1, n, 1, dtype=torch.float64),
        torch.ones(1, dtype=torch.float64), classes=(cmt, torch.zeros_like(cmt)))
    np.testing.assert_allclose(traj[:, 8:12], xs2[0, 0, 1:].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cost, float(c2[0, 0]), rtol=1e-12)


@pytest.mark.parametrize("n_cg", CG_DEPTHS)
def test_constrained_op_counts_match_code(contact_exe, n_cg):
    """The closed-form counts behind the bounds of K2 with classes, K4 and
    K6 equal what frozen_step and class_step do, kind by kind, and the
    tangent of frozen_step on duals (with solve_frozen's second PCG) in
    total; K4's one-thread body (linearize_point) does what
    point_jvp_op_kinds counts, kind by kind, and the factored least work
    (jvp_point_least_ops: the primal once, the directions' tangent sweeps
    without their values) is that count without the values of the
    directions' dual inputs but the first's, and lies below a plain frozen
    step and nx + na forward-mode tangents of it: K4's bound takes the
    smaller."""
    model, _, _, _, counts, _, _, _ = run_contact(contact_exe, n_cg)
    frozen = device_step.frozen_step_op_kinds(model, n_cg)
    assert counts[0] == {k: frozen.get(k, 0) for k in KINDS}
    cls = device_step.class_step_op_kinds(model)
    assert counts[1] == {k: cls.get(k, 0) for k in KINDS}
    assert sum(counts[2].values()) - sum(counts[0].values()) == \
        device_step.frozen_step_tangent_ops(model, n_cg)
    point = device_step.point_jvp_op_kinds(model, n_cg)
    assert counts[3] == {k: point.get(k, 0) for k in KINDS}
    p = device_step._jvp_parts(model, n_cg, 1)
    k_dirs = 2 * model.nq + model.num_actions
    # the directions' values, less the dynamics' (forward_dynamics without
    # the Euler update, mass_matrix), which the primal takes from them
    dyn_values = (sum(device_step.step_op_kinds(model).values()) - 4 * model.nq
                  + sum(device_step._mass_matrix_ops(model).values()))
    values = (k_dirs * sum(p["col"].values()) + model.nq * sum(p["qcol"].values())
              - dyn_values)
    least = device_step.jvp_point_least_ops(model, n_cg)
    assert least == sum(counts[3].values()) - values
    plain, tangent = device_step.frozen_step_ops(model, n_cg)
    assert least < plain + k_dirs * tangent


def test_qdiv_gives_the_division_bit_for_bit(contact_exe):
    """The frozen PCG's quotients (csrc/common.cuh qdiv, which skips the
    division of a zero by a finite nonzero divisor) have the bits of the
    IEEE division, in f64 and f32: signed zeros over divisors of both
    signs and a denormal one, and the division itself where the divisor is
    infinite, zero or NaN or the dividend nonzero."""
    out = subprocess.run([str(contact_exe), "qdiv"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()
    assert len(out) == 2
    for line in out:
        bits = line.split()
        assert len(bits) == 24 and bits[0::2] == bits[1::2], line


def test_pack_model_appends_constraint_rows():
    """The packed model of a model with limit and Coulomb rows carries one
    bound per row and each row's dof and kind, in ops/contact.py's order;
    the constrained kernels take it and refuse a model without rows."""
    model = limited_cartpole().replace(
        coulomb_friction=torch.tensor([0.0, 0.3], dtype=torch.float64))
    from nimblephysics_tpu_torch.models.model import relax_limits

    P, I = device_step.pack_model(model)
    P0, I0 = device_step.pack_model(relax_limits(model))
    lim = [-0.6, -0.5, 0.6, 0.5, 0.3 * float(model.dt)]
    np.testing.assert_allclose(P[P0.numel():].numpy(), lim, rtol=1e-15)
    # dofs of the rows, then their kinds (lower, lower, upper, upper, Coulomb)
    np.testing.assert_array_equal(I[I0.numel():].numpy(), [0, 1, 0, 1, 1, 0, 0, 1, 1, 2])
    assert device_step.check_contact_model("k", limited_cartpole()) == 4
    with pytest.raises(NotImplementedError, match="M4"):
        device_step.check_contact_model(
            "k", builders.pendulum(dtype=torch.float64, device="cpu").replace(
                q_lower=torch.tensor([-1.0], dtype=torch.float64),
                q_upper=torch.tensor([1.0], dtype=torch.float64), servo_dofs=(0,)))
    with pytest.raises(NotImplementedError, match="fused_class_rollout_ok"):
        device_step.check_contact_model("k", relax_limits(limited_cartpole()))


# The jump worm's device code: the contact-free step, frozen_step with
# contact rows and friction coupling (per thread), and the lane-group bodies
# of csrc/frozen_group.cuh that K2, K4 and K5 run at m = 28:
# group_frozen_step, K5's linearize_vjp_group, K4's linearize_jvp_group and
# K2's rollout_group, each on one host thread per lane (HostGroup in
# csrc/lane_group.cuh: a barrier for the warp's sync, its shuffles through
# an exchange array in the device's butterfly order), and K7's thread body
# and lane-group body (csrc/lcp.cu), all built for the host. Reads
# "nb nq na m ns n nr ni n_cg", the packed reals and ints, the cost weights
# and targets (8 nq + na), then n points (x, u, cmask, us); writes the
# operation counts by kind of device_step and of frozen_step at the first
# point on the counting scalar, and of K5's and then K4's group bodies there
# summed over their lanes, each on a group of kK5Group (kK4Group) lanes and
# on one of a single lane; then
# per point device_step's, frozen_step's and
# group_frozen_step's (q', v'), K5's (fx, fu) and K4's (fx, fu) (a group of
# kK4Group lanes, kK4Rhs tangent solves per pass); then K2's group trajectory
# of n steps from the first point (the points' u and classes, zero gains)
# and its cost; then the butterfly sums over groups of 32, 16 and 8 lanes,
# lane l holding |x[l mod 2 nq]| of the first point, as each lane sees them.
WORM_MAIN = CONTACT_MAIN[:CONTACT_MAIN.index("static void print_ops()")].replace(
    '#include "rollout.cu"', '#include "rollout.cu"\n#include "lcp.cu"\n#include "riccati.cu"').replace(
    "long long g_ops[8];", "thread_local long long g_ops[8];") + r"""
#include <memory>

static long long g_sum[8];
static std::mutex g_sum_mu;

// a lane thread's counts into g_sum
static void fold_ops() {
  std::lock_guard<std::mutex> lk(g_sum_mu);
  for (int k = 0; k < 8; ++k) { g_sum[k] += nptt::g_ops[k]; nptt::g_ops[k] = 0; }
}

static void print_ops() {
  for (int k = 0; k < 8; ++k) printf("%lld ", nptt::g_ops[k]);
  printf("\n");
  for (int k = 0; k < 8; ++k) nptt::g_ops[k] = 0;
}

static void print_sum() {
  for (int k = 0; k < 8; ++k) printf("%lld ", g_sum[k]);
  printf("\n");
  for (int k = 0; k < 8; ++k) g_sum[k] = 0;
}

template <int G>
static void print_butterfly(const std::vector<double>& vals) {
  const int n = (int)vals.size();
  std::vector<double> out(G);
  nptt::HostGroup<G>::run([&](nptt::HostGroup<G> g) {
    double v[1] = {std::fabs(vals[g.lane % n])};
    g.sum(v);
    out[g.lane] = v[0];
  });
  for (int l = 0; l < G; ++l) printf("%.17g ", out[l]);
  printf("\n");
}

template <int NB, int NQ, int NA, int M, int NS>
void run(const double* P, const int* I, const double* w, const std::vector<double>& pts, int n,
         int n_cg) {
  constexpr int NX = 2 * NQ, E = NX + NA + 2 * M, G2 = nptt::kK2Group, G5 = nptt::kK5Group,
                G4 = nptt::kK4Group, NP4 = nptt::kK4Rhs;
  using nptt::C;
  std::vector<double> xs(n * NX), us(n * NA), cms(n * M), ucl(n * M);
  for (int p = 0; p < n; ++p) {
    for (int i = 0; i < NX; ++i) xs[p * NX + i] = pts[p * E + i];
    for (int a = 0; a < NA; ++a) us[p * NA + a] = pts[p * E + NX + a];
    for (int r = 0; r < M; ++r) cms[p * M + r] = pts[p * E + NX + NA + r];
    for (int r = 0; r < M; ++r) ucl[p * M + r] = pts[p * E + NX + NA + M + r];
  }
  {
    C q[NQ], v[NQ], u[NA], qn[NQ], vn[NQ];
    for (int i = 0; i < NQ; ++i) { q[i] = C(xs[i]); v[i] = C(xs[NQ + i]); }
    for (int a = 0; a < NA; ++a) u[a] = C(us[a]);
    nptt::device_step<double, C, NB, NQ, NA>(P, I, q, v, u, qn, vn);
    print_ops();
    nptt::frozen_step<double, C, NB, NQ, NA, M, NS>(P, I, q, v, u, cms.data(), ucl.data(), n_cg,
                                                    qn, vn);
    print_ops();
    std::vector<C> fxc(NX * NX), fuc(NX * NA);
    auto shc = std::make_unique<nptt::VjpShared<C, NB, NQ, M>>();
    nptt::HostGroup<G5>::run([&](nptt::HostGroup<G5> g) {
      nptt::linearize_vjp_group<double, C, NB, NQ, NA, M, NS, G5>(
          g, *shc, 0, n_cg, P, I, xs.data(), us.data(), cms.data(), ucl.data(), fxc.data(),
          fuc.data());
      fold_ops();
    });
    print_sum();
    nptt::HostGroup<1>::run([&](nptt::HostGroup<1> g) {
      nptt::linearize_vjp_group<double, C, NB, NQ, NA, M, NS, 1>(
          g, *shc, 0, n_cg, P, I, xs.data(), us.data(), cms.data(), ucl.data(), fxc.data(),
          fuc.data());
      fold_ops();
    });
    print_sum();
    auto sh4c = std::make_unique<nptt::JvpShared<C, NB, NQ, NA, M, NS, NP4>>();
    nptt::HostGroup<G4>::run([&](nptt::HostGroup<G4> g) {
      nptt::linearize_jvp_group<double, C, NB, NQ, NA, M, NS, G4, NP4>(
          g, *sh4c, 0, n_cg, P, I, xs.data(), us.data(), cms.data(), ucl.data(), fxc.data(),
          fuc.data());
      fold_ops();
    });
    print_sum();
    auto sh1c = std::make_unique<nptt::JvpShared<C, NB, NQ, NA, M, NS, NP4>>();
    nptt::HostGroup<1>::run([&](nptt::HostGroup<1> g) {
      nptt::linearize_jvp_group<double, C, NB, NQ, NA, M, NS, 1, NP4>(
          g, *sh1c, 0, n_cg, P, I, xs.data(), us.data(), cms.data(), ucl.data(), fxc.data(),
          fuc.data());
      fold_ops();
    });
    print_sum();
  }
  std::vector<double> fx(n * NX * NX), fu(n * NX * NA), qg(n * NQ), vg(n * NQ),
      fx4(n * NX * NX), fu4(n * NX * NA);
  auto sh5 = std::make_unique<nptt::VjpShared<double, NB, NQ, M>>();
  auto sh2 = std::make_unique<nptt::FrozenShared<double, NB, NQ, M, 1>>();
  auto sh4 = std::make_unique<nptt::JvpShared<double, NB, NQ, NA, M, NS, NP4>>();
  for (long long p = 0; p < n; ++p) {
    nptt::HostGroup<G5>::run([&](nptt::HostGroup<G5> g) {
      nptt::linearize_vjp_group<double, double, NB, NQ, NA, M, NS, G5>(
          g, *sh5, p, n_cg, P, I, xs.data(), us.data(), cms.data(), ucl.data(), fx.data(),
          fu.data());
    });
    nptt::HostGroup<G4>::run([&](nptt::HostGroup<G4> g) {
      nptt::linearize_jvp_group<double, double, NB, NQ, NA, M, NS, G4, NP4>(
          g, *sh4, p, n_cg, P, I, xs.data(), us.data(), cms.data(), ucl.data(), fx4.data(),
          fu4.data());
    });
    nptt::HostGroup<G2>::run([&](nptt::HostGroup<G2> g) {
      double qn[NQ], vn[NQ];
      nptt::group_frozen_step<double, NB, NQ, NA, M, NS, G2>(
          g, *sh2, P, I, &xs[p * NX], &xs[p * NX + NQ], &us[p * NA], &cms[p * M], &ucl[p * M],
          n_cg, qn, vn);
      if (g.lane == 0)
        for (int i = 0; i < NQ; ++i) { qg[p * NQ + i] = qn[i]; vg[p * NQ + i] = vn[i]; }
    });
  }
  for (int p = 0; p < n; ++p) {
    double qo[NQ], vo[NQ], qf[NQ], vf[NQ];
    nptt::device_step<double, double, NB, NQ, NA>(P, I, &xs[p * NX], &xs[p * NX + NQ],
                                                  &us[p * NA], qo, vo);
    nptt::frozen_step<double, double, NB, NQ, NA, M, NS>(P, I, &xs[p * NX], &xs[p * NX + NQ],
                                                         &us[p * NA], &cms[p * M], &ucl[p * M],
                                                         n_cg, qf, vf);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", qo[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", vo[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", qf[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", vf[i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", qg[p * NQ + i]);
    for (int i = 0; i < NQ; ++i) printf("%.17g ", vg[p * NQ + i]);
    for (int i = 0; i < NX * NX; ++i) printf("%.17g ", fx[p * NX * NX + i]);
    for (int i = 0; i < NX * NA; ++i) printf("%.17g ", fu[p * NX * NA + i]);
    for (int i = 0; i < NX * NX; ++i) printf("%.17g ", fx4[p * NX * NX + i]);
    for (int i = 0; i < NX * NA; ++i) printf("%.17g ", fu4[p * NX * NA + i]);
    printf("\n");
  }
  std::vector<double> xs_ref((n + 1) * NX, 0.0), Kg(n * NA * NX, 0.0), kf(n * NA, 0.0),
      xs2((n + 1) * NX), us2(n * NA);
  double alpha = 1.0, cost = 0.0;
  nptt::HostGroup<G2>::run([&](nptt::HostGroup<G2> g) {
    nptt::rollout_group<double, NB, NQ, NA, M, NS, G2>(
        g, *sh2, 0, 1, n, n_cg, P, I, w, xs.data(), xs_ref.data(), us.data(), Kg.data(),
        kf.data(), &alpha, cms.data(), ucl.data(), xs2.data(), us2.data(), &cost);
  });
  for (int t = 0; t < n; ++t) {
    for (int i = 0; i < NX; ++i) printf("%.17g ", xs2[(t + 1) * NX + i]);
    printf("\n");
  }
  printf("%.17g\n", cost);
  std::vector<double> vals(xs.begin(), xs.begin() + NX);
  print_butterfly<32>(vals);
  print_butterfly<16>(vals);
  print_butterfly<8>(vals);
}

// K7's thread body and its lane-group body (on kK7Group host threads):
// after the worm's input, "m n iters", findex, then n LCPs (A row-major,
// b, lo, hi, fscale, x0); writes each LCP's two solutions.
template <int M>
void run_pgs() {
  constexpr int G7 = nptt::kK7Group;
  int m, n, iters;
  if (scanf("%d %d %d", &m, &n, &iters) != 3 || m != M) return;
  std::vector<int> fi(M);
  for (auto& f : fi) if (scanf("%d", &f) != 1) return;
  std::vector<double> buf(M * M + 5 * M), out(M), outg(M);
  for (int k = 0; k < n; ++k) {
    for (auto& x : buf) if (scanf("%lf", &x) != 1) return;
    const double* b = buf.data() + M * M;
    nptt::pgs_lcp<double, M>(buf.data(), 1, b, b + M, b + 2 * M, b + 3 * M, b + 4 * M,
                             fi.data(), iters, out.data());
    nptt::HostGroup<G7>::run([&](nptt::HostGroup<G7> g) {
      nptt::pgs_group<double, M, G7>(g, buf.data(), b, b + M, b + 2 * M, b + 3 * M, b + 4 * M,
                                     fi.data(), iters, outg.data());
    });
    for (int i = 0; i < M; ++i) printf("%.17g ", out[i]);
    for (int i = 0; i < M; ++i) printf("%.17g ", outg[i]);
    printf("\n");
  }
}

// K1's group body (csrc/riccati.cu riccati_group) over B worlds, on
// k1_lanes(nx) host threads per world and then on one; writes, for each,
// a line per world: its K, k, dV and ok.
template <int NX, int NA, int G>
static void riccati_on(int B, int T, const std::vector<std::vector<double>>& a) {
  std::vector<double> K(B * T * NA * NX), k(B * T * NA), dV(2 * B);
  std::unique_ptr<bool[]> ok(new bool[B]);
  auto sh = std::make_unique<nptt::RiccatiShared<double, NX, NA>>();
  const double* in[7];
  for (int i = 0; i < 7; ++i) in[i] = a[i].data();
  for (long long b = 0; b < B; ++b)
    nptt::HostGroup<G>::run([&](nptt::HostGroup<G> g) {
      nptt::riccati_group<double, NX, NA, G>(g, *sh, b, T, in, a[7].data(), a[8].data(),
                                             a[9].data(), K.data(), k.data(), dV.data(),
                                             ok.get());
    });
  for (int b = 0; b < B; ++b) {
    for (int e = 0; e < T * NA * NX; ++e) printf("%.17g ", K[b * T * NA * NX + e]);
    for (int e = 0; e < T * NA; ++e) printf("%.17g ", k[b * T * NA + e]);
    printf("%.17g %.17g %d\n", dV[2 * b], dV[2 * b + 1], ok[b] ? 1 : 0);
  }
}

// after "riccati" on the command line: reads "nx na B T" and the inputs
// fx, fu, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg, each row-major
static int run_riccati() {
  int nx, na, B, T;
  if (scanf("%d %d %d %d", &nx, &na, &B, &T) != 4) return 2;
  const long long n = (long long)B * T;
  const long long sizes[10] = {n * nx * nx, n * nx * na, n * nx, n * na, n * nx * nx,
                               n * na * na, n * na * nx, (long long)B * nx,
                               (long long)B * nx * nx, B};
  std::vector<std::vector<double>> a(10);
  for (int i = 0; i < 10; ++i) {
    a[i].resize(sizes[i]);
    for (auto& x : a[i]) if (scanf("%lf", &x) != 1) return 2;
  }
#define RICCATI(NX, NA)                                        \
  if (nx == NX && na == NA) {                                  \
    riccati_on<NX, NA, nptt::k1_lanes(NX)>(B, T, a);           \
    riccati_on<NX, NA, 1>(B, T, a);                            \
    return 0;                                                  \
  }
  RICCATI(4, 1)
  RICCATI(6, 3)
  RICCATI(8, 2)
#undef RICCATI
  return 3;
}

int main(int argc, char** argv) {
  if (argc > 1 && std::string(argv[1]) == "riccati") return run_riccati();
  int nb, nq, na, m, ns, n, nr, ni, n_cg;
  if (scanf("%d %d %d %d %d %d %d %d %d", &nb, &nq, &na, &m, &ns, &n, &nr, &ni, &n_cg) != 9)
    return 2;
  std::vector<double> P(nr), w(8 * nq + na), pts(n * (2 * nq + na + 2 * m));
  std::vector<int> I(ni);
  for (auto& x : P) if (scanf("%lf", &x) != 1) return 2;
  for (auto& x : I) if (scanf("%d", &x) != 1) return 2;
  for (auto& x : w) if (scanf("%lf", &x) != 1) return 2;
  for (auto& x : pts) if (scanf("%lf", &x) != 1) return 2;
#define RUN(NB, NQ, NA, M, NS) \
  if (nb == NB && nq == NQ && na == NA && m == M && ns == NS) { \
    run<NB, NQ, NA, M, NS>(P.data(), I.data(), w.data(), pts, n, n_cg); run_pgs<M>(); return 0; }
  NPTT_WORM_SHAPES(RUN)
  return 3;
}
"""


@pytest.fixture(scope="module")
def worm_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the device step cannot be built for the host")
    d = tmp_path_factory.mktemp("worm_step")
    (d / "worm_main.cpp").write_text(WORM_MAIN)
    exe = d / "worm_main"
    subprocess.run(["g++", "-std=c++17", "-O0", "-pthread", "-I", str(CSRC),
                    str(d / "worm_main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    return exe


def worm_points(sliding, n=6, seed=7, mass_scale=1.0, box_on_link=False):
    """Worm states 3 mm into the floor, moving down, links near their lower
    limits, strong pushes; with ``sliding`` the root also slides (x velocity
    up to 1.5 m/s), so friction rows ride the cone (UPPER); the classes come
    from the port's classify_points. ``mass_scale`` scales the bodies' masses
    and inertias. With ``box_on_link`` the box rides the first link about
    the root's centre, that link tilted by 0.3 rad: the contact rows then
    turn with q (on the stock worm the box sits on the translational root,
    and dJ/dq = 0)."""
    from nimblephysics_tpu_torch.models.builders import _tf
    from nimblephysics_tpu_torch.models.model import make_shape
    from nimblephysics_tpu_torch.ops import frozen_contact as tf

    model = builders.jump_worm(dtype=torch.float64, device="cpu")
    if mass_scale != 1.0:
        model = model.replace(mass=model.mass * mass_scale, moment=model.moment * mass_scale)
    if box_on_link:
        box = make_shape("box", 1, offset=_tf([0.0, -0.125, 0.0]), params=[0.1, 0.1, 0.1, 0.0],
                         dtype=torch.float64)
        model = model.replace(shapes=(box, model.shapes[1]))
    rng = np.random.default_rng(seed)
    q = 0.01 * rng.standard_normal((n, 4))
    q[:, 1] += -0.528
    q[:, 2:] = 0.5 * np.abs(q[:, 2:])
    if box_on_link:
        q[:, 2] += 0.3
    v = 0.05 * rng.standard_normal((n, 4))
    v[:, 1] = -0.4
    v[:, 0] = rng.uniform(-1.5, 1.5, n) if sliding else 0.0
    x = np.concatenate([q, v], axis=1)
    u = 20.0 * rng.standard_normal((n, 2))
    cl, _ = tf.classify_points(model, torch.tensor(x), model.action_to_tau(torch.tensor(u)))
    return model, x, u, cl.cmask.numpy(), cl.us.numpy()


WORM_W = np.concatenate([[0.0, 2.0, 0.0, 0.0], np.zeros(4), np.full(2, 1e-5),
                         [0.0, 20.0] + [0.0] * 6, [0.0, -0.4] + [0.0] * 6,
                         [0.0, -0.4] + [0.0] * 6])


@functools.lru_cache(maxsize=None)
def run_worm(exe, n_cg, sliding, mass_scale=1.0, box_on_link=False):
    """(model, x, u, cmask, us, operation counts of device_step, frozen_step
    and K5's and K4's group bodies for one point, one row per point, K2's
    trajectory and cost, the PGS LCPs and K7's thread and group bodies'
    solutions side by side, the butterfly sums over groups of 32, 16 and 8
    lanes)."""
    from nimblephysics_tpu_torch.ops import contact as tc
    from nimblephysics_tpu_torch.ops import dynamics as td
    from nimblephysics_tpu_torch.ops.collide import detect_contacts

    model, x, u, cm, us = worm_points(sliding, mass_scale=mass_scale, box_on_link=box_on_link)
    P, I = device_step.pack_model(model)
    m = tc.lcp_dim(model)
    n = x.shape[0]
    xt, ut = torch.tensor(x), torch.tensor(u)
    q, v = xt[:, :4], xt[:, 4:]
    kin = td.forward_kinematics(model, q)
    v_star = v + model.dt * td.aba(model, q, v, model.action_to_tau(ut), kin=kin)
    _, A, b, lo, hi, fs, _ = tc.build_constraint_system(model, q, v_star, kin,
                                                        detect_contacts(model, kin.T_wb))
    x0 = 0.01 * np.random.default_rng(2).standard_normal(b.shape)
    lcps = np.concatenate([A.reshape(n, -1).numpy(), b.numpy(), lo.numpy(), hi.numpy(),
                           fs.numpy(), x0], axis=1)
    head = (model.num_bodies, model.nq, model.num_actions, m, 8, n, P.numel(), I.numel(), n_cg)
    text = "\n".join([" ".join(str(v) for v in head),
                      " ".join(repr(v) for v in P.tolist()),
                      " ".join(str(v) for v in I.tolist()),
                      " ".join(repr(float(v)) for v in WORM_W),
                      " ".join(repr(float(v)) for v in
                               np.concatenate([x, u, cm, us], axis=1).ravel()),
                      f"{m} {n} 60", " ".join(str(f) for f in tc.lcp_findex(model)),
                      " ".join(repr(float(v)) for v in lcps.ravel())])
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True,
                         check=True, timeout=120).stdout.splitlines()
    counts = [dict(zip(KINDS, (int(c) for c in line.split()))) for line in out[:6]]
    rows = np.array([[float(t) for t in line.split()] for line in out[6:6 + n]])
    traj = np.array([[float(t) for t in line.split()] for line in out[6 + n:6 + 2 * n]])
    cost = float(out[6 + 2 * n])
    sums = [np.array([float(t) for t in line.split()]) for line in out[7 + 2 * n:10 + 2 * n]]
    pgs = np.array([[float(t) for t in line.split()] for line in out[10 + 2 * n:10 + 3 * n]])
    return (model, x, u, cm, us, counts, rows, traj, cost,
            (A, b, lo, hi, fs, torch.tensor(x0)), pgs, sums)


# PCG depth: bench.py's 12 on points where the root does not slide, and 1
# and 2 on sliding points. Where friction rows ride the cone, the coupled
# normal equations are badly conditioned, and from a few PCG iterations on
# any two summation orders differ there by up to ~1e-9 relative in f64:
# the JAX package's own frozen step and the port's plain one do at 12
# iterations (7 of 28 rows clamping), as do this host build and the plain
# version; at 1 and 2 iterations all three agree to rounding.
WORM_CASES = ((12, False), (1, True), (2, True))
# ... and at depth 12 there, where the one-thread frozen_step, its lane-group
# form and the plain step part by far more than rounding
CONE_DEPTH = 12


@pytest.mark.parametrize("n_cg,sliding", WORM_CASES)
def test_worm_steps_match_plain(worm_exe, n_cg, sliding):
    from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_frozen_for_trace

    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, n_cg, sliding)
    xt, ut = torch.tensor(x), torch.tensor(u)
    np.testing.assert_allclose(rows[:, :8], dyn_for_trace(model)(xt, ut).numpy(),
                               rtol=1e-12, atol=1e-12)
    frozen = dyn_frozen_for_trace(model, n_cg)(xt, ut, torch.tensor(cm), torch.tensor(us))
    np.testing.assert_allclose(rows[:, 8:16], frozen.numpy(), rtol=1e-12, atol=1e-12)
    # the lane-group frozen step of K2 at m = 28 (csrc/frozen_group.cuh):
    # the one-thread step's arithmetic, operation for operation
    np.testing.assert_array_equal(rows[:, 16:24], rows[:, 8:16])
    assert cm[:, :24].any() and ((us != 0).any() == sliding)


@pytest.mark.parametrize("n_cg,sliding", WORM_CASES)
def test_linearize_vjp_thread_matches_jacrev(worm_exe, n_cg, sliding):
    """K5's lane-group body (linearize_vjp_group: the primal and adjoint
    PCGs together, the tangent through the factors of A) against jacrev of
    the plain frozen step's v' half (linearize_vjp_plain), the q' rows
    [I, dt I] and 0 exactly."""
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_vjp_plain

    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, n_cg, sliding)
    n = x.shape[0]
    fx, fu = linearize_vjp_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                 (torch.tensor(cm)[:, None], torch.tensor(us)[:, None]), n_cg)
    np.testing.assert_allclose(rows[:, 24:88], fx.reshape(n, -1).numpy(), rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(rows[:, 88:104], fu.reshape(n, -1).numpy(), rtol=1e-11,
                               atol=1e-11)
    top = np.concatenate([np.eye(4), float(model.dt) * np.eye(4)], axis=1).ravel()
    assert (rows[:, 24:56] == top).all() and (rows[:, 88:96] == 0).all()


def _split_jacfwd(model, x, u, cm, us, n_cg):
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_split_plain

    n = x.shape[0]
    fx, fu = linearize_split_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                   (torch.tensor(cm)[:, None], torch.tensor(us)[:, None]), n_cg)
    return np.concatenate([fx.reshape(n, -1).numpy(), fu.reshape(n, -1).numpy()], axis=1)


@pytest.mark.parametrize("n_cg,sliding", WORM_CASES)
def test_linearize_jvp_group_matches_jacfwd(worm_exe, n_cg, sliding):
    """K4's lane-group body at the worm's m = 28 (linearize_jvp_group: the
    primal PCG, the tangent right-hand sides through the factors of A, one
    lane per direction, and the nx + na tangent PCGs over one Qf) against
    jacfwd of the plain frozen step (linearize_split_plain, the implicit
    tangent of the linear solve), the q' rows [I, dt I] and 0 exactly."""
    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, n_cg, sliding)
    want = _split_jacfwd(model, x, u, cm, us, n_cg)
    np.testing.assert_allclose(rows[:, 104:184], want, rtol=1e-11, atol=1e-11)
    top = np.concatenate([np.eye(4), float(model.dt) * np.eye(4)], axis=1).ravel()
    assert (rows[:, 104:136] == top).all() and (rows[:, 168:176] == 0).all()


@pytest.mark.parametrize("n_cg", (1, 2))
def test_linearize_group_bodies_where_the_contact_rows_turn(worm_exe, n_cg):
    """K4's and K5's group bodies on a worm whose box rides its first link
    (worm_points' box_on_link), at sliding points: there the contact rows
    turn with q, so the terms of the tangent in dJ (K4's dJ v', dJ^T x~,
    dJ^T z, dJ pz; K5's G_k) are live, which on the stock worm vanish.
    Held as on the stock worm: K4 to jacfwd, K5 to jacrev, at 1e-11."""
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_vjp_plain

    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, n_cg, True, 1.0, True)
    n = x.shape[0]
    np.testing.assert_array_equal(rows[:, 16:24], rows[:, 8:16])
    np.testing.assert_allclose(rows[:, 104:184], _split_jacfwd(model, x, u, cm, us, n_cg),
                               rtol=1e-11, atol=1e-11)
    fx, fu = linearize_vjp_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                 (torch.tensor(cm)[:, None], torch.tensor(us)[:, None]), n_cg)
    want = np.concatenate([fx.reshape(n, -1).numpy(), fu.reshape(n, -1).numpy()], axis=1)
    np.testing.assert_allclose(rows[:, 24:104], want, rtol=1e-11, atol=1e-11)
    assert cm[:, :24].any() and (us != 0).any()


# A worm 20 times lighter: at its sliding points entries of C A R, not only
# the unclamped rows' 1, attain max|Qf| (about 7), so the tangent of reg =
# eps max(max|Qf|, 1)^2 by jnp's tie rule is not zero there
LIGHT_WORM = 0.05


@pytest.mark.parametrize("n_cg", (1, 2))
def test_linearize_vjp_thread_follows_the_tie_rule(worm_exe, n_cg):
    """K5's group body against jacrev on the light worm, where its tie-rule
    terms (csrc/linearize.cu vjp_tie_terms) are live; its group step
    against the one-thread step. The tie terms move the rows by ~1e-12 of
    their largest entry (reg's eps is 1e-10 in f64), so the rows are held
    to 1e-13 of it: both agree to rounding (4e-16) at these depths, and the
    body without its tie terms misses by 1.0e-12."""
    from nimblephysics_tpu_torch.ops.cuda_linearize import linearize_vjp_plain

    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, n_cg, True, LIGHT_WORM)
    n = x.shape[0]
    np.testing.assert_array_equal(rows[:, 16:24], rows[:, 8:16])
    fx, fu = linearize_vjp_plain(model, torch.tensor(x)[:, None], torch.tensor(u)[:, None],
                                 (torch.tensor(cm)[:, None], torch.tensor(us)[:, None]), n_cg)
    want = np.concatenate([fx.reshape(n, -1).numpy(), fu.reshape(n, -1).numpy()], axis=1)
    np.testing.assert_allclose(rows[:, 24:104], want, rtol=0, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("n_cg", (1, 2))
def test_linearize_jvp_group_follows_the_tie_rule(worm_exe, n_cg):
    """K4's group body against jacfwd on the light worm, where the tangent
    of reg = eps max(max|Qf|, 1)^2 by jnp's tie rule is live (tie_terms in
    csrc/linearize.cu, dreg x_C in each tangent right-hand side): held to
    1e-13 of the largest entry, as K5's body is; the tie rule moves the
    entries by ~1e-12 of it."""
    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, n_cg, True, LIGHT_WORM)
    want = _split_jacfwd(model, x, u, cm, us, n_cg)
    np.testing.assert_allclose(rows[:, 104:184], want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_worm_group_bodies_on_the_cone_at_depth_12(worm_exe):
    """The group bodies at the sliding points at PCG depth 12 in f64. There
    the cone points' normal equations amplify rounding: the plain step and
    the one-thread frozen_step, which sum in other orders, part by up to
    ~1e-7 relative (7e-8 measured), so the group step is held to the
    one-thread step bit for bit (it repeats its arithmetic operation for
    operation), and both, like K5's group body against jacrev (4e-8
    measured), to the plain versions within 1e-6, the largest move
    chip_smoke.py excuses."""
    from nimblephysics_tpu_torch.ops.cuda_linearize import dyn_frozen_for_trace, linearize_vjp_plain

    model, x, u, cm, us, _, rows, *_ = run_worm(worm_exe, CONE_DEPTH, True)
    n = x.shape[0]
    xt, ut, cmt, ust = (torch.tensor(a) for a in (x, u, cm, us))
    frozen = dyn_frozen_for_trace(model, CONE_DEPTH)(xt, ut, cmt, ust).numpy()
    np.testing.assert_array_equal(rows[:, 16:24], rows[:, 8:16])
    for got in (rows[:, 8:16], rows[:, 16:24]):
        np.testing.assert_allclose(got, frozen, rtol=1e-6, atol=1e-6 * np.abs(frozen).max())
    fx, fu = linearize_vjp_plain(model, xt[:, None], ut[:, None], (cmt[:, None], ust[:, None]),
                                 CONE_DEPTH)
    want = np.concatenate([fx.reshape(n, -1).numpy(), fu.reshape(n, -1).numpy()], axis=1)
    np.testing.assert_allclose(rows[:, 24:104], want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    want = _split_jacfwd(model, x, u, cm, us, CONE_DEPTH)
    np.testing.assert_allclose(rows[:, 104:184], want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert (us != 0).any()


def test_group_butterfly_sum_matches_the_plain_sum(worm_exe):
    """HostGroup's butterfly (the host form of the device's __shfl_xor_sync
    sums) over groups of 32, 16 and 8 lanes: every lane gets the plain sum
    of the lanes' values, to rel 1e-15."""
    import math

    _, x, *_, sums = run_worm(worm_exe, 2, True)
    for got, G in zip(sums, (32, 16, 8)):
        want = math.fsum(abs(x[0][lane % 8]) for lane in range(G))
        assert got.shape == (G,) and (got == got[0]).all()
        assert abs(got[0] - want) <= 1e-15 * want, (G, got[0], want)


def test_worm_rollout_thread_matches_plain(worm_exe):
    """K2's lane-group body (rollout_group) on the worm with bench.py's
    target cost."""
    from nimblephysics_tpu_torch.ops.cuda_rollout import rollout_gains_plain
    from nimblephysics_tpu_torch.trajectory.costs import QuadraticCost, QuadraticFinalCost

    model, x, u, cm, us, _, _, traj, cost, *_ = run_worm(worm_exe, 2, True)
    n = x.shape[0]
    goal = torch.tensor(WORM_W[-8:])
    rc = QuadraticCost(model, wq=torch.tensor(WORM_W[:4]), wu=1e-5, x_goal=goal)
    fc = QuadraticFinalCost(model, wx=torch.tensor(WORM_W[10:18]), x_goal=goal)
    xs2, _, c2 = rollout_gains_plain(
        model, rc, fc, torch.tensor(x[:1]), torch.zeros(1, n + 1, 8, dtype=torch.float64),
        torch.tensor(u)[None], torch.zeros(1, n, 2, 8, dtype=torch.float64),
        torch.zeros(1, n, 2, dtype=torch.float64), torch.ones(1, dtype=torch.float64),
        classes=(torch.tensor(cm)[None], torch.tensor(us)[None]), cg_iters=2)
    np.testing.assert_allclose(traj, xs2[0, 0, 1:].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cost, float(c2[0, 0]), rtol=1e-12)


def test_pgs_thread_matches_plain(worm_exe):
    """K7's thread body (pgs_lcp) against pgs_batched_plain on the worm's
    friction-coupled LCPs from a warm start."""
    from nimblephysics_tpu_torch.ops.contact import lcp_findex
    from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched_plain

    model, *_, lcps, pgs, _ = run_worm(worm_exe, 2, True)
    m = pgs.shape[1] // 2
    want = pgs_batched_plain(*lcps, lcp_findex(model), 60)
    np.testing.assert_allclose(pgs[:, :m], want.numpy(), rtol=1e-12, atol=1e-14)
    assert np.abs(pgs[:, :m]).max() > 1e-3


def test_pgs_group_matches_plain(worm_exe):
    """K7's lane-group body (pgs_group: each lane keeps its rows of A and
    their residual w = A x - b current, updated by every row's change of x
    instead of recomputed) against pgs_batched_plain and the thread body on
    the same LCPs. The updated residual rounds otherwise than pgs_solve's
    dot products: over the 60 sweeps the solutions part by at most rel
    1e-13 of the largest impulse (7.2e-15 measured on these LCPs)."""
    from nimblephysics_tpu_torch.ops.contact import lcp_findex
    from nimblephysics_tpu_torch.ops.cuda_lcp import pgs_batched_plain

    model, *_, lcps, pgs, _ = run_worm(worm_exe, 2, True)
    m = pgs.shape[1] // 2
    want = pgs_batched_plain(*lcps, lcp_findex(model), 60).numpy()
    scale = np.abs(want).max()
    for ref in (want, pgs[:, :m]):
        np.testing.assert_allclose(pgs[:, m:], ref, rtol=0, atol=1e-13 * scale)
    assert (lcps[4] > 0).any() and np.abs(pgs[:, m:]).max() > 1e-3


def run_riccati_group(exe, nx, na, T=11, B=3):
    """K1's group body on the host (worm_exe's "riccati" mode) on
    tests/test_torch_riccati.py's worlds, world 1 with an indefinite Quu
    (luu = -50 at t = 3): the inputs and, per group size (k1_lanes(nx) and
    one lane), K, k, dV and ok."""
    from test_torch_riccati import _inputs

    args = list(_inputs(nx, na, T, B, seed=2))
    args[5] = args[5].copy()
    args[5][1, 3] = -50.0
    text = "\n".join([f"{nx} {na} {B} {T}"] + [" ".join(repr(float(v)) for v in a.ravel())
                                                for a in args])
    out = subprocess.run([str(exe), "riccati"], input=text, capture_output=True, text=True,
                         check=True, timeout=120).stdout.splitlines()
    rows = np.array([[float(v) for v in line.split()] for line in out])
    assert rows.shape == (2 * B, T * na * (nx + 1) + 3)
    outs = []
    for r in (rows[:B], rows[B:]):
        outs.append((r[:, :T * na * nx].reshape(B, T, na, nx),
                     r[:, T * na * nx:T * na * (nx + 1)].reshape(B, T, na),
                     r[:, -3:-1], r[:, -1].astype(bool)))
    return args, outs


@pytest.mark.parametrize("nx,na", [(4, 1), (6, 3), (8, 2)])
def test_riccati_group_matches_plain(worm_exe, nx, na):
    """K1's body (csrc/riccati.cu riccati_group: a lane per row of Vxx on a
    group of k1_lanes(nx) lanes, the inputs staged in chunks of kK1Chunk
    steps, T = 11 so that a chunk is partial and the runs of lu start off
    16-byte alignment) on host threads, and on one lane, against
    riccati_backward_plain in f64 to 1e-12 of each output's largest
    magnitude, with the PD flags identical (world 1 indefinite)."""
    from nimblephysics_tpu_torch.ops.cuda_riccati import riccati_backward_plain

    args, outs = run_riccati_group(worm_exe, nx, na)
    K, k, dV, ok = riccati_backward_plain(*(torch.tensor(a) for a in args))
    assert ok.tolist() == [True, False, True]
    for got in outs:
        for a, b in zip(got[:3], (K, k, dV)):
            b = b.numpy()
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
        assert got[3].tolist() == ok.tolist()


@pytest.mark.parametrize("n_cg", (12, 2))
def test_worm_op_counts_match_code(worm_exe, n_cg):
    """The closed forms behind the worm kernels' bounds: device_step and
    frozen_step kind by kind (two-dof joint, contact rows, friction
    coupling), and K5's body kind by kind on a group of kK5Group lanes and
    on a group of one. K5's bound counts the one-lane primal and nq reverse
    sweeps of the factored tangent, each a tangent sweep of the inputs
    that a direction of q runs on dual numbers, without their values."""
    model, *_ = run_worm(worm_exe, n_cg, False)
    counts = run_worm(worm_exe, n_cg, False)[5]
    step = device_step.step_op_kinds(model)
    assert counts[0] == {k: step.get(k, 0) for k in KINDS}
    frozen = device_step.frozen_step_op_kinds(model, n_cg)
    assert counts[1] == {k: frozen.get(k, 0) for k in KINDS}
    for got, group in ((counts[2], device_step.K5_GROUP), (counts[3], 1)):
        want = device_step.vjp_point_op_kinds(model, n_cg, group)
        assert got == {k: want.get(k, 0) for k in KINDS}
    p = device_step._vjp_parts(model, n_cg, 1)
    k_dirs = 2 * model.nq + model.num_actions
    dual = {c: sum(p[c].values()) + sum(device_step._tangent_kinds(p[c]).values())
            for c in ("col", "qcol")}
    primal = (sum(counts[3].values()) - k_dirs * (dual["col"] + sum(p["contract"].values()))
              - model.nq * (dual["qcol"] + sum(p["qcontract"].values())))
    sweep = dual["col"] + dual["qcol"] - sum(p["col"].values()) - sum(p["qcol"].values())
    least = device_step.vjp_point_least_ops(model, n_cg)
    assert least == primal + model.nq * sweep
    assert least < sum(counts[3].values()) < sum(counts[2].values())


@pytest.mark.parametrize("n_cg", (12, 2))
def test_worm_jvp_op_counts_match_code(worm_exe, n_cg):
    """The closed form behind the bound of K4's worm instance (K3 with
    classes= and linearize_split at m = 28): its group body kind by kind on
    a group of kK4Group lanes and on a group of one (every lane's share of
    the work counted), and its least work, the one-lane body without the
    values of its directions' dual inputs and without q' = q + dt v, below
    the count it replaces (a plain frozen step and nx + na forward-mode
    tangents of it)."""
    model, *_ = run_worm(worm_exe, n_cg, False)
    counts = run_worm(worm_exe, n_cg, False)[5]
    for got, group in ((counts[4], device_step.K4_GROUP), (counts[5], 1)):
        want = device_step.jvp_point_op_kinds(model, n_cg, group)
        assert got == {k: want.get(k, 0) for k in KINDS}
    p = device_step._jvp_parts(model, n_cg, 1)
    k_dirs = 2 * model.nq + model.num_actions
    values = k_dirs * sum(p["col"].values()) + model.nq * sum(p["qcol"].values())
    least = device_step.jvp_point_least_ops(model, n_cg)
    assert least == sum(counts[5].values()) - values - 2 * model.nq
    frozen, tangent = device_step.frozen_step_ops(model, n_cg)
    assert least < frozen + k_dirs * tangent


def test_pack_model_carries_the_worm_slots():
    """The packed worm: a two-dof body with its second axis and subspace
    column, the limit rows, then per slot its corner in the body frame, the
    floor's normal and offset, the friction coefficient and its body; the
    frozen kernels take it and the class-rollout kernel refuses it."""
    from nimblephysics_tpu_torch.ops.collide import _box_corners

    model = builders.jump_worm(dtype=torch.float64, device="cpu")
    P, I = device_step.pack_model(model)
    nb, nq, na = 3, 4, 2
    k_size = nb * 78 + 3 * nq + 2 * na + 4
    np.testing.assert_array_equal(P[69:72].numpy(), [0.0, 1.0, 0.0])        # axis 1
    np.testing.assert_array_equal(P[72:78].numpy(), [0, 0, 0, 0, 1.0, 0])   # S column 1
    np.testing.assert_array_equal(P[k_size:k_size + 4].numpy(), [0.0, 0.0, np.pi, np.pi])
    slots = P[k_size + 4:].reshape(8, 8).numpy()
    np.testing.assert_array_equal(slots[:, :3], _box_corners(model.shapes[0].params).numpy())
    np.testing.assert_array_equal(slots[:, 3:], np.tile([0, 1.0, 0, -0.575, 1.0], (8, 1)))
    assert I[-8:].tolist() == [0] * 8 and I[2 * nb:3 * nb].tolist() == [0, 2, 3]
    assert device_step.check_frozen_model("k", model) == 28
    with pytest.raises(NotImplementedError, match="fused_class_rollout_ok"):
        device_step.check_contact_model("k", model)
    sphere = model.replace(shapes=(model.shapes[0].__class__(
        kind="sphere", body_index=0, offset=model.shapes[0].offset,
        params=model.shapes[0].params, friction=model.shapes[0].friction,
        restitution=model.shapes[0].restitution), model.shapes[1]))
    with pytest.raises(NotImplementedError, match="M4"):
        device_step.check_frozen_model("k", sphere)
